"""Context parallelism of the port (Taylor and SSD) against the JAX package.

The same numpy inputs go through the JAX package's
``taylor_attention_context_parallel`` (4 forced host devices in a
subprocess, as ``tests/test_distributed.py`` runs it) and through the
port's on 4 ``gloo`` ranks (one torch thread each, a file store under
``tmp_path``), all of whose checks run in one spawn.  Tolerances are the
reference test's own: atol 5e-5 for Taylor (outputs, and the port's CP
gradient against its unsharded chunked path), atol 1e-4 for SSD (values
and the gradient in x against ``jax.grad`` of the unsharded
``_ssd_chunked``, since the reference's own SSD CP test fails under the
installed jax).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.backends import resolve_backend
from repro_torch.backends.taylor import _kernel_fits
from repro_torch.configs import get_reduced
from repro_torch.core import TaylorConfig, taylor_attention_chunked
from repro_torch.core.context_parallel import (
    attention_context_parallel,
    taylor_attention_context_parallel,
)
from repro_torch.core.ssd_context_parallel import ssd_context_parallel
from repro_torch.launch.mesh import SingleMesh, make_host_mesh
from repro_torch.launch.spawn import run_ranks

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 64
# (b, h, hk, n, d, dv): the reference test's shape, and a GQA case with b 2
TAYLOR_CASES = {"reference": (1, 2, 1, 512, 16, 16), "gqa": (2, 4, 2, 512, 16, 16)}
SSD_SHAPE = dict(b=2, n=512, H=4, Pd=16, G=1, N=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def taylor_inputs(case):
    b, h, hk, n, d, dv = TAYLOR_CASES[case]
    rng = np.random.default_rng(0)
    return (rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, hk, n, d)).astype(np.float32),
            rng.normal(size=(b, hk, n, dv)).astype(np.float32),
            rng.normal(size=(b, h, n, dv)).astype(np.float32))  # cotangent


def ssd_inputs():
    s = SSD_SHAPE
    rng = np.random.default_rng(0)
    x = rng.normal(size=(s["b"], s["n"], s["H"], s["Pd"])).astype(np.float32)
    dt = (np.abs(rng.normal(size=(s["b"], s["n"], s["H"]))) * 0.1).astype(np.float32)
    A = -(np.abs(rng.normal(size=(s["H"],))) + 0.5).astype(np.float32)
    B = rng.normal(size=(s["b"], s["n"], s["G"], s["N"])).astype(np.float32)
    C = rng.normal(size=(s["b"], s["n"], s["G"], s["N"])).astype(np.float32)
    t = rng.normal(size=x.shape).astype(np.float32)
    return x, dt, A, B, C, t


def _ranks(rank, world):
    """Every port check of this file on one rank of a 2×2 / 1×4 mesh."""
    T = lambda a: torch.from_numpy(a)
    cfg = TaylorConfig()
    out = {}
    mesh = make_host_mesh(1, 4, device="cpu")
    for case in TAYLOR_CASES:
        q, k, v, t = map(T, taylor_inputs(case))
        out[f"taylor_{case}"] = taylor_attention_context_parallel(
            q, k, v, cfg, mesh, "model", chunk=CHUNK).numpy()
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        y = taylor_attention_context_parallel(qs, ks, vs, cfg, mesh, "model", chunk=CHUNK)
        grads = torch.autograd.grad((y * t).sum(), (qs, ks, vs))
        out[f"taylor_grad_{case}"] = [g.numpy() for g in grads]
    # the batch over "data" (2) and the sequence over "model" (2)
    q, k, v, _ = map(T, taylor_inputs("gqa"))
    out["taylor_dp"] = taylor_attention_context_parallel(
        q, k, v, cfg, make_host_mesh(2, 2, device="cpu"), "model", chunk=CHUNK,
        dp_axis="data").numpy()
    x, dt, A, B, C, t = map(T, ssd_inputs())
    xs = x.clone().requires_grad_()
    y = ssd_context_parallel(xs, dt, A, B, C, mesh, "model", chunk=CHUNK)
    out["ssd"] = y.detach().numpy()
    out["ssd_grad_x"] = torch.autograd.grad((y * t).sum(), xs)[0].numpy()
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("cp") / "store"
    outs = run_ranks(_ranks, 4, backend="gloo", init_file=str(path))
    for other in outs[1:]:  # every rank returns the whole outputs
        for key in outs[0]:
            a, b = outs[0][key], other[key]
            for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(x, y, err_msg=key)
    return outs[0]


@pytest.fixture(scope="module")
def jax_cp(tmp_path_factory):
    """The JAX package's CP function on 4 forced host devices, in a
    subprocess (the test process keeps its one device)."""
    d = tmp_path_factory.mktemp("jaxcp")
    for case in TAYLOR_CASES:
        q, k, v, _ = taylor_inputs(case)
        np.savez(d / f"{case}.npz", q=q, k=k, v=v)
    code = textwrap.dedent(f"""
        import json, sys
        import jax, jax.numpy as jnp, numpy as np
        from repro.core import TaylorConfig
        from repro.core.context_parallel import taylor_attention_context_parallel
        mesh = jax.make_mesh((4,), ("seq",))
        for case in {list(TAYLOR_CASES)!r}:
            z = np.load(r"{d}/" + case + ".npz")
            out = taylor_attention_context_parallel(
                jnp.asarray(z["q"]), jnp.asarray(z["k"]), jnp.asarray(z["v"]),
                TaylorConfig(), mesh, "seq", chunk={CHUNK})
            np.save(r"{d}/" + case + "_out.npy", np.asarray(out))
        print("JAX_CP_OK")
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600, cwd=str(ROOT))
    assert "JAX_CP_OK" in proc.stdout, proc.stderr[-4000:]
    return {case: np.load(d / f"{case}_out.npy") for case in TAYLOR_CASES}


def _unsharded(case, grad=False):
    q, k, v, t = (torch.from_numpy(a) for a in taylor_inputs(case))
    if not grad:
        return taylor_attention_chunked(q, k, v, TaylorConfig(), chunk=CHUNK).numpy()
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    y = taylor_attention_chunked(qs, ks, vs, TaylorConfig(), chunk=CHUNK)
    return [g.numpy() for g in torch.autograd.grad((y * t).sum(), (qs, ks, vs))]


@pytest.mark.parametrize("case", list(TAYLOR_CASES))
def test_taylor_cp_equals_the_jax_cp_function(port, jax_cp, case):
    np.testing.assert_allclose(port[f"taylor_{case}"], jax_cp[case], atol=5e-5)


@pytest.mark.parametrize("case", list(TAYLOR_CASES))
def test_taylor_cp_equals_the_unsharded_chunked_scan(port, case):
    import jax.numpy as jnp

    from repro.core import TaylorConfig as JTaylorConfig
    from repro.core import taylor_attention_chunked as j_chunked

    q, k, v, _ = taylor_inputs(case)
    ref = np.asarray(j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               JTaylorConfig(), chunk=CHUNK))
    np.testing.assert_allclose(port[f"taylor_{case}"], ref, atol=5e-5)
    np.testing.assert_allclose(port[f"taylor_{case}"], _unsharded(case), atol=5e-5)


@pytest.mark.parametrize("case", list(TAYLOR_CASES))
def test_taylor_cp_gradient_equals_the_unsharded_path(port, case):
    for g, ref, name in zip(port[f"taylor_grad_{case}"], _unsharded(case, grad=True), "qkv"):
        np.testing.assert_allclose(g, ref, atol=5e-5, err_msg=name)


def test_taylor_cp_with_the_batch_over_data(port):
    np.testing.assert_allclose(port["taylor_dp"], _unsharded("gqa"), atol=5e-5)


def test_ssd_cp_equals_the_unsharded_jax_scan_values_and_gradient(port):
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import _ssd_chunked as j_ssd

    x, dt, A, B, C, t = (jnp.asarray(a) for a in ssd_inputs())
    ref = j_ssd(x, dt, A, B, C, chunk=CHUNK)
    np.testing.assert_allclose(port["ssd"], np.asarray(ref), atol=1e-4)
    g = jax.grad(lambda x: jnp.sum(j_ssd(x, dt, A, B, C, chunk=CHUNK) * t))(x)
    np.testing.assert_allclose(port["ssd_grad_x"], np.asarray(g), atol=1e-4)


def test_the_cp_envelope_and_its_errors():
    cfg = get_reduced("smollm-135m")
    cp = cfg.replace(attn_sharding="cp")
    assert resolve_backend(cp).supports_cp and _kernel_fits(cfg) and not _kernel_fits(cp)
    with pytest.raises(ValueError, match="attn_sharding must be tp|cp"):
        cfg.replace(attn_sharding="sp")
    decayed = cp.replace(taylor=dataclasses.replace(cfg.taylor, decay=0.9))
    with pytest.raises(ValueError, match="incompatible with context parallelism"):
        resolve_backend(decayed)
    with pytest.raises(ValueError, match="context parallelism runs the torch chunked scan"):
        resolve_backend(cp.replace(attn_impl="cuda"))
    for name in ("softmax", "softmax_window", "linear_elu"):
        with pytest.raises(ValueError, match="does not support context parallelism"):
            resolve_backend(cp.replace(attention=name))
        assert not resolve_backend(cfg.replace(attention=name)).supports_cp
    q = torch.zeros(1, 2, 128, 16)
    mesh = SingleMesh(("data", "model"))
    with pytest.raises(ValueError, match="does not support context parallelism"):
        attention_context_parallel(q, q[:, :1], q[:, :1], cfg.replace(attention="softmax"),
                                   mesh, "model")
    with pytest.raises(AssertionError):  # n must divide into shards × chunk
        taylor_attention_context_parallel(q[:, :, :100], q[:, :1, :100], q[:, :1, :100],
                                          TaylorConfig(), mesh, "model", chunk=64)
    with pytest.raises(NotImplementedError, match="no mergeable state"):
        resolve_backend(cfg.replace(attention="softmax")).merge_state(None, None)
    # on one rank the CP path is the chunked scan
    out = attention_context_parallel(q, q[:, :1], q[:, :1], cfg.replace(attn_chunk=64),
                                     mesh, "model")
    ref = taylor_attention_chunked(q, q[:, :1], q[:, :1], cfg.taylor, chunk=64)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
