"""The port's Taylor-attention gradients against the JAX package's.

Three layers, each on the same numpy inputs as its JAX counterpart:

  * ``core.taylor_vjp.taylor_chunked_core`` (the torch recompute backward)
    against ``jax.grad`` through ``repro.core.taylor_vjp.taylor_chunked_core``;
  * the backward kernels' plain version (``ref.taylor_attention_bwd_ref``,
    what ``kernel.taylor_bwd`` runs on CPU tensors) against the Pallas pair
    ``taylor_bwd_pallas(interpret=True)`` on padded inputs both accept;
  * the trainable wrapper (``backward="torch"`` and, on CPU tensors, the
    kernels' plain versions) against ``jax.grad`` of the reference wrapper.

Tolerances: relative error max|Δ| / max|ref| < 1e-4 in float32 — gradients
sum over whole sequences in different orders in the two frameworks (the
forward parity bound is 2e-5, and the JAX kernel tests hold the Pallas
backward to 1e-4 absolute).  The CUDA kernels are held to the plain version
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.feature_map import TaylorConfig as JTaylorConfig
from repro.core.feature_map import layernorm_no_affine as j_layernorm
from repro.core.taylor_vjp import taylor_chunked_core as j_core
from repro.kernels.taylor_attention.kernel_bwd import taylor_bwd_pallas
from repro.kernels.taylor_attention.ops import (
    taylor_attention_kernel_trainable as j_trainable,
)
from repro_torch.core.feature_map import TaylorConfig, layernorm_no_affine
from repro_torch.core.taylor import taylor_attention_chunked, taylor_attention_parallel
from repro_torch.core.taylor_vjp import taylor_chunked_core
from repro_torch.kernels.taylor_attention import kernel as K
from repro_torch.kernels.taylor_attention import ops
from repro_torch.kernels.taylor_attention.ref import (
    taylor_attention_bwd_ref,
    taylor_attention_ref,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def torch_grads(fn, arrays, t):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*xs)
    return torch.autograd.grad((out * torch.from_numpy(t)).sum(), xs)


def jax_grads(fn, arrays, t):
    return jax.grad(lambda *xs: jnp.sum(fn(*xs) * jnp.asarray(t)),
                    argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))


@pytest.mark.parametrize("order, g, minus_one", [(1, 2, False), (2, 2, False),
                                                 (2, 3, False), (2, 2, True)])
def test_core_vjp_matches_jax(rng, order, g, minus_one):
    b, hk, n, d, dv, chunk = 2, 2, 64, 16, 8, 16
    q, k, v = normal(rng, b, hk, g, n, d), normal(rng, b, hk, n, d), normal(rng, b, hk, n, dv)
    q, k = np.asarray(j_layernorm(q)), np.asarray(j_layernorm(k))
    t = normal(rng, b, hk, g, n, dv)
    tcfg = TaylorConfig(order=order, minus_one=minus_one)
    jcfg = JTaylorConfig(order=order, minus_one=minus_one)
    ours = torch_grads(lambda *x: taylor_chunked_core(*x, tcfg, chunk), (q, k, v), t)
    theirs = jax_grads(lambda *x: j_core(*x, jcfg, chunk), (q, k, v), t)
    for name, a, b_ in zip(("dq", "dk", "dv"), ours, theirs):
        assert rel(a, b_) < TOL, (name, rel(a, b_))


def test_chunked_training_saves_only_qkv(rng):
    # The plain-training case routes through the custom Function: its graph
    # holds (q, k, v), not one moment state per chunk.
    cfg = TaylorConfig()
    q = torch.randn(1, 2, 64, 16, requires_grad=True)
    k = torch.randn(1, 1, 64, 16, requires_grad=True)
    v = torch.randn(1, 1, 64, 16, requires_grad=True)
    out = taylor_attention_chunked(q, k, v, cfg, chunk=16)
    node = out.grad_fn
    while "ChunkedCore" not in type(node).__name__:
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    assert len(saved) == 3 and all(s.shape[-2] == 64 for s in saved)
    # and its gradient is autodiff's of the quadratic form
    t = torch.randn(1, 2, 64, 16)
    g1 = torch.autograd.grad((out * t).sum(), (q, k, v))
    g2 = torch.autograd.grad((taylor_attention_parallel(q, k, v, cfg) * t).sum(), (q, k, v))
    for a, b_ in zip(g1, g2):
        assert rel(a, b_) < TOL


@pytest.mark.parametrize("order, g, d", [(2, 2, 64), (1, 1, 64), (2, 1, 128)])
def test_plain_backward_matches_pallas_pair(rng, order, g, d):
    # Padded inputs both accept: n a multiple of the Pallas chunk (128),
    # d ∈ {64, 128}, zero-free inputs.
    bk, n, dv = 2, 256, 64
    q = np.asarray(j_layernorm(normal(rng, bk, g, n, d)))
    k = np.asarray(j_layernorm(normal(rng, bk, n, d)))
    v = normal(rng, bk, n, dv)
    dout = normal(rng, bk, g, n, dv)
    out = np.asarray(taylor_attention_ref(
        *(torch.tensor(x)[None] for x in (q, k, v)), alpha=3.0, order=order)[0])
    ours = K.taylor_bwd(*(torch.tensor(x) for x in (q, k, v, dout, out)),
                        alpha=3.0, order=order)
    theirs = taylor_bwd_pallas(*(jnp.asarray(x) for x in (q, k, v, dout, out)),
                               alpha=3.0, order=order, interpret=True)
    for name, a, b_ in zip(("dq", "dk", "dv"), ours, theirs):
        assert a.dtype == torch.float32 and tuple(a.shape) == b_.shape, name
        assert rel(a, b_) < TOL, (name, rel(a, b_))


def test_plain_backward_is_autodiff_of_the_plain_forward(rng):
    q = layernorm_no_affine(torch.randn(1, 2, 3, 96, 16)).requires_grad_()
    k = layernorm_no_affine(torch.randn(1, 2, 96, 16)).requires_grad_()
    v = torch.randn(1, 2, 96, 24, requires_grad=True)
    for order in (1, 2):
        out = taylor_attention_ref(q, k, v, alpha=2.0, order=order)
        t = torch.randn_like(out)
        want = torch.autograd.grad((out * t).sum(), (q, k, v))
        got = taylor_attention_bwd_ref(q.detach(), k.detach(), v.detach(), t,
                                       out.detach(), alpha=2.0, order=order)
        for a, b_ in zip(got, want):
            assert rel(a, b_) < 1e-5


GRAD_SWEEP = [
    # order, b, h, hk, n, d, dv, chunk: tests/test_kernels.py's GRAD_SWEEP
    (2, 2, 4, 2, 256, 64, 64, 128),     # order-2, GQA g=2
    (2, 1, 2, 1, 300, 64, 64, 128),     # n=300: the zero-padding contract
]


@pytest.mark.parametrize("case", GRAD_SWEEP, ids=[str(c) for c in GRAD_SWEEP])
@pytest.mark.parametrize("backward", ["torch", "auto"])
def test_trainable_wrapper_matches_jax(rng, case, backward):
    order, b, h, hk, n, d, dv, chunk = case
    q, k, v = normal(rng, b, h, n, d), normal(rng, b, hk, n, d), normal(rng, b, hk, n, dv)
    t = normal(rng, b, h, n, dv)
    tcfg, jcfg = TaylorConfig(order=order), JTaylorConfig(order=order)
    ours = torch_grads(lambda *x: ops.taylor_attention_kernel_trainable(
        *x, tcfg, chunk=chunk, backward=backward), (q, k, v), t)
    theirs = jax_grads(lambda *x: j_trainable(*x, jcfg, chunk=chunk, interpret=True),
                       (q, k, v), t)
    for name, a, b_ in zip(("dq", "dk", "dv"), ours, theirs):
        assert rel(a, b_) < TOL, (name, rel(a, b_))


def test_padded_gradients_are_exactly_zero(rng):
    # The wrapper pads n 200 -> 256, d 48 -> 64, dv 80 -> 80 (value tile 8):
    # every gradient of a padded row or column must come out exactly zero.
    b, h, hk, n, d, dv = 1, 2, 1, 200, 48, 80
    q = torch.from_numpy(normal(rng, b, h, n, d))
    k = torch.from_numpy(normal(rng, b, hk, n, d))
    v = torch.from_numpy(normal(rng, b, hk, n, dv))
    qn, kn = layernorm_no_affine(q), layernorm_no_affine(k)
    qp, kp, vp, dims = ops._kernel_layout(qn, kn, v)
    assert (dims.n_pad, dims.d_pad) == (256, 64)
    dout = ops._grouped_value_layout(torch.from_numpy(normal(rng, b, h, n, dv)), dims)
    out = K.taylor_fwd(qp, kp, vp, alpha=ops._effective_alpha(3.0, dims))
    dq, dk, dv_ = K.taylor_bwd(qp, kp, vp, dout, out,
                               alpha=ops._effective_alpha(3.0, dims))
    assert torch.equal(dq[..., n:, :], torch.zeros_like(dq[..., n:, :]))
    assert torch.equal(dq[..., d:], torch.zeros_like(dq[..., d:]))
    assert torch.equal(dk[:, n:], torch.zeros_like(dk[:, n:]))
    assert torch.equal(dk[..., d:], torch.zeros_like(dk[..., d:]))
    assert torch.equal(dv_[:, n:], torch.zeros_like(dv_[:, n:]))
    assert float(dq[..., :n, :d].abs().max()) > 0 and float(dk[:, :n, :d].abs().max()) > 0


def test_backward_dispatch_follows_the_reference_envelope(monkeypatch):
    calls = []
    real = ops.taylor_bwd
    monkeypatch.setattr(ops, "taylor_bwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = TaylorConfig()

    def grad(dv, backward):
        q = torch.randn(1, 2, 64, 16, requires_grad=True)
        k = torch.randn(1, 1, 64, 16)
        v = torch.randn(1, 1, 64, dv)
        out = ops.taylor_attention_kernel_trainable(q, k, v, cfg, chunk=16,
                                                    backward=backward)
        return torch.autograd.grad(out.sum(), q)[0]

    grad(64, "auto")
    assert calls == [1]           # inside the envelope: the kernel pair
    grad(136, "auto")
    assert calls == [1]           # dv_pad 136 > 128: the torch recompute
    grad(64, "torch")
    assert calls == [1]
    with pytest.raises(ValueError, match="envelope"):
        grad(136, "cuda")
    dims = ops._layout_dims(torch.empty(1, 2, 8, 16), torch.empty(1, 1, 8, 16),
                            torch.empty(1, 1, 8, 64))
    assert ops._kernel_bwd_ok(cfg, dims)
    assert not ops._kernel_bwd_ok(TaylorConfig(sym_state=True), dims)
    with pytest.raises(NotImplementedError, match="minus_one"):
        ops.taylor_attention_kernel_trainable(torch.randn(1, 1, 8, 16), torch.randn(1, 1, 8, 16),
                                              torch.randn(1, 1, 8, 16),
                                              TaylorConfig(minus_one=True))
    with pytest.raises(ValueError, match="backward"):
        ops.taylor_attention_kernel_trainable(torch.randn(1, 1, 8, 16), torch.randn(1, 1, 8, 16),
                                              torch.randn(1, 1, 8, 16), backward="pallas")


def test_bwd_kernel_entry_refuses_non_cpu_tensors_without_launching():
    q = torch.empty(2, 1, 128, 64, device="meta")
    k = torch.empty(2, 128, 64, device="meta")
    before = (K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches)
    with pytest.raises(ValueError, match="CPU or all-CUDA"):
        K.taylor_bwd(q, k, k, q, q, alpha=3.0)
    assert (K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches) == before
