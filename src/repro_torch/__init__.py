"""PyTorch port of the Higher Order Linear Transformer, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package reimplements its
serving path and inference forward in PyTorch, with the Taylor-attention
forward as a hand-written CUDA kernel (``repro_torch.kernels``).  It never
imports JAX or ``repro``.

Entry points (``models.lm.lm_init``, ``serve.ServeEngine``,
``serve.generate``) run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU request they
raise instead of falling back.
"""
