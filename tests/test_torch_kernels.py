"""The port's Taylor-attention kernel wrapper against the JAX package's.

On the CPU the port's ``taylor_attention_kernel`` runs the kernel's plain
PyTorch version through the same layout and padding code the CUDA kernel
gets; it is held to the JAX Pallas kernel (interpret mode) and to the JAX
plain reference on the same numpy inputs, with relative error < 2e-5 in
float32 (the bound of tests/test_kernels.py).  The CUDA kernel itself is
checked against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.feature_map import layernorm_no_affine as j_layernorm
from repro.kernels.taylor_attention.ops import taylor_attention_kernel as j_kernel
from repro.kernels.taylor_attention.ref import taylor_attention_ref as j_ref
from repro_torch.kernels.taylor_attention import kernel as K
from repro_torch.kernels.taylor_attention import ops
from repro_torch.kernels.taylor_attention.ref import taylor_attention_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5

SWEEP = [
    # b, h, hk, n, d, dv, order
    (1, 2, 1, 140, 16, 16, 2),   # sequence padding 140 -> 256
    (1, 4, 1, 64, 16, 16, 2),    # MQA, one state for 4 q-heads
    (1, 2, 2, 64, 16, 40, 2),    # dv != d, padded to the value tile
    (2, 4, 2, 64, 24, 24, 2),    # head dim padded 24 -> 32
    (1, 2, 1, 64, 16, 16, 1),    # order 1
]


def rel(port, ref) -> float:
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _jax_ref(q, k, v, order):
    b, h, n, d = q.shape
    hk = k.shape[1]
    qn = j_layernorm(jnp.asarray(q)).reshape(b, hk, h // hk, n, d)
    kn = j_layernorm(jnp.asarray(k))
    return j_ref(qn, kn, jnp.asarray(v), 3.0, order).reshape(b, h, n, v.shape[-1])


@pytest.mark.parametrize("case", SWEEP, ids=[str(c) for c in SWEEP])
def test_kernel_wrapper_matches_jax(rng, case):
    b, h, hk, n, d, dv, order = case
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, dv)).astype(np.float32)
    out = ops.taylor_attention_kernel(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), order=order
    )
    assert tuple(out.shape) == (b, h, n, dv)
    assert rel(out, _jax_ref(q, k, v, order)) < TOL
    jax_out = j_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), order=order,
                       interpret=True)
    assert rel(out, jax_out) < TOL


def test_plain_version_matches_jax_ref(rng):
    q = rng.normal(size=(2, 3, 2, 50, 16)).astype(np.float32)
    k = rng.normal(size=(2, 3, 50, 16)).astype(np.float32)
    v = rng.normal(size=(2, 3, 50, 8)).astype(np.float32)
    for order in (1, 2):
        out = taylor_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), alpha=2.0, order=order)
        ref = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2.0, order)
        assert rel(out, ref) < TOL


def test_plain_version_clamps_like_the_kernel():
    # order 1 with a = 1: p = 1 + s = -4.77e-7 is a denominator inside the
    # clamp.  The kernel clamps |den| < 1e-6 to +1e-6; core._safe_div would
    # keep the sign and give the opposite output.
    q = np.full((1, 1, 1, 1, 1), 1.000000477, np.float32)
    k = np.full((1, 1, 1, 1), -1.0, np.float32)
    v = np.ones((1, 1, 1, 1), np.float32)
    out = taylor_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), alpha=1.0, order=1)
    ref = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    p = np.float32(1.0) + np.float32(1.000000477) * np.float32(-1.0)
    assert -1e-6 < p < 0
    np.testing.assert_allclose(out.numpy().item(), p / 1e-6, rtol=1e-6)


@pytest.mark.parametrize("d, d_pad, dv, dv_pad, n, n_pad", [
    (64, 64, 64, 64, 2048, 2048),     # the main path: no padding
    (112, 128, 112, 112, 384, 384),   # zamba2's head dim -> 128, chunk 64
    (16, 16, 40, 48, 140, 256),
    (24, 32, 24, 32, 64, 128),
])
def test_layout_pads_only_what_the_cuda_tiles_need(d, d_pad, dv, dv_pad, n, n_pad):
    q = torch.empty(1, 2, n, d, device="meta")
    k = torch.empty(1, 1, n, d, device="meta")
    v = torch.empty(1, 1, n, dv, device="meta")
    dims = ops._layout_dims(q, k, v)
    assert (dims.d_pad, dims.dv_pad, dims.n_pad) == (d_pad, dv_pad, n_pad)
    dvt, chunk = K.TILES[d_pad]
    assert dv_pad % dvt == 0 and n_pad % chunk == 0
    # the logit scale keeps the TRUE head dim
    alpha = ops._effective_alpha(3.0, dims)
    assert abs(1 / (alpha * d_pad**0.5) - 1 / (3.0 * d**0.5)) < 1e-12


def test_head_dim_over_the_envelope_raises():
    q = torch.empty(1, 2, 8, 256, device="meta")
    kv = torch.empty(1, 1, 8, 256, device="meta")
    with pytest.raises(ValueError, match="exceeds"):
        ops._layout_dims(q, kv, kv)


def test_forward_only_until_the_backward_kernels_land(rng):
    q = torch.randn(1, 2, 16, 16, requires_grad=True)
    k = torch.randn(1, 1, 16, 16)
    with pytest.raises(NotImplementedError):
        ops.taylor_attention_kernel(q, k, k)
    with torch.no_grad():
        assert ops.taylor_attention_kernel(q, k, k).shape == (1, 2, 16, 16)


def test_non_cpu_tensors_never_take_the_plain_version():
    # A tensor that is not on the CPU goes to the CUDA kernel or raises; the
    # plain version is only for CPU tensors.
    q = torch.empty(2, 1, 128, 64, device="meta")
    k = torch.empty(2, 128, 64, device="meta")
    before = K.taylor_fwd.launches
    with pytest.raises(ValueError, match="CPU or all-CUDA"):
        K.taylor_fwd(q, k, k, alpha=3.0)
    assert K.taylor_fwd.launches == before
