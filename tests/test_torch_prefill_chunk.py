"""Chunked prefill of the port against the JAX package's, on the same weights.

The reduced smollm-135m (d_model 64, 4/2 heads, head dim 16, attn_chunk 16,
float32) runs a 37-token prompt (not a multiple of the chunk: 16 + 16 + 5)
through ``prefill_chunked`` in both packages, on every backend the port
serves, the Taylor variants (decay, ``sym_state``) and the 3-layer
taylor/window/taylor hybrid of tests/test_torch_hybrid.py.  Logits and
every cache leaf answer to relative error max|Δ| / max|ref| <= 1e-5 against
JAX (``JAX_TOL``; float32, sums in another order).  The port's chunked
result must also match its own whole-prompt ``prefill`` at atol = rtol =
2e-3, the limits of tests/test_serve_sharded.py (``SELF_TOL``).  Order 2
and the hybrid also run a 700-token prompt in chunks of 256, and a batched
chunk whose rows continue from different positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core import feature_map as jfm
from repro.models import lm as jlm
from repro.serve import prefill_chunked as j_prefill_chunked
from repro.serve import slots as jslots
from repro_torch.configs import get_reduced
from repro_torch.core import feature_map as tfm
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import prefill, prefill_chunked
from repro_torch.serve import slots as tslots

JAX_TOL = 1e-5
SELF_TOL = 2e-3
PROMPT, CHUNK, N_MAX = 37, 16, 48
LONG_PROMPT, LONG_CHUNK, LONG_N_MAX = 700, 256, 768  # the card check's shape: 256 + 256 + 188
WINDOW = 8  # shorter than the prompt: the window ring wraps
HYBRID = dict(pattern=("attn", "attn", "attn"), n_groups=1,
              attention_schedule={1: "softmax_window"})

CASES = {
    "taylor": {},
    "softmax": dict(attention="softmax"),
    "softmax_window": dict(attention="softmax_window"),
    "linear_elu": dict(attention="linear_elu"),
    "taylor_decay": dict(taylor=("decay", 0.95)),
    "taylor_sym_state": dict(taylor=("sym_state", True)),
    "hybrid": HYBRID,
}


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def cfgs(case):
    """(JAX, port) reduced smollm-135m configs of one case."""
    kw = dict(CASES[case], attn_window=WINDOW)
    jkw, tkw = dict(kw), dict(kw)
    if "taylor" in kw:
        name, value = kw["taylor"]
        jkw["taylor"] = jfm.TaylorConfig(**{name: value})
        tkw["taylor"] = tfm.TaylorConfig(**{name: value})
    return j_get_reduced("smollm-135m").replace(**jkw), get_reduced("smollm-135m", **tkw)


@pytest.fixture(scope="module")
def jax_params():
    """JAX weights per layout: the reduced model's own, and the hybrid's."""
    return {
        "plain": jlm.lm_init(jax.random.PRNGKey(0), cfgs("taylor")[0]),
        "hybrid": jlm.lm_init(jax.random.PRNGKey(0), cfgs("hybrid")[0]),
    }


def model(jax_params, case):
    jcfg, cfg = cfgs(case)
    jp = jax_params["hybrid" if case == "hybrid" else "plain"]
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def prompt(rng, b=2):
    t = rng.integers(0, 128, (b, PROMPT)).astype(np.int32)
    return t, torch.from_numpy(t.astype(np.int64))


def state_pairs(tc, jc):
    """(name, port leaf, JAX leaf) of every cache leaf, run by run."""
    assert len(tc["group"]) == len(jc["group"]) and len(tc["tail"]) == len(jc["tail"])
    for ts, js in zip(tc["group"] + tc["tail"], jc["group"] + jc["tail"]):
        assert type(ts).__name__ == type(js).__name__
        for name, a, b in zip(ts._fields, ts, js):
            if b is None:
                assert a is None, name
                continue
            assert tuple(a.shape) == tuple(b.shape), name
            yield name, a, b


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_chunked_matches_jax(jax_params, rng, case):
    jcfg, cfg, jp, tp = model(jax_params, case)
    jt, tt = prompt(rng)
    jl, jc = j_prefill_chunked(jp, {"tokens": jnp.asarray(jt)}, jcfg, N_MAX, CHUNK)
    tl, tc = prefill_chunked(tp, {"tokens": tt}, cfg, N_MAX, CHUNK)
    assert tuple(tl.shape) == (2, cfg.vocab)
    assert rel(tl, jl) <= JAX_TOL
    for name, a, b in state_pairs(tc, jc):
        if name == "length":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert rel(a, b) <= JAX_TOL, (name, rel(a, b))


@pytest.mark.parametrize("case", [c for c in CASES if c != "linear_elu"])
def test_prefill_chunked_matches_own_prefill(jax_params, rng, case):
    _, cfg, _, tp = model(jax_params, case)
    _, tt = prompt(rng)
    wl, wc = prefill(tp, {"tokens": tt}, cfg, N_MAX)
    cl, cc = prefill_chunked(tp, {"tokens": tt}, cfg, N_MAX, CHUNK)
    np.testing.assert_allclose(cl.numpy(), wl.numpy(), atol=SELF_TOL, rtol=SELF_TOL)
    for name, a, b in state_pairs(cc, wc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SELF_TOL, rtol=SELF_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["taylor", "hybrid"])
def test_prefill_chunked_long_prompt(jax_params, rng, case):
    """A 700-token prompt in chunks of 256 (a three-chunk continuation whose
    last chunk is short, as chip_smoke.py runs it at full width): logits and
    every cache leaf against JAX at 1e-5 and against the port's own
    whole-prompt ``prefill`` at 2e-3."""
    jcfg, cfg, jp, tp = model(jax_params, case)
    jt = rng.integers(0, 128, (1, LONG_PROMPT)).astype(np.int32)
    tt = torch.from_numpy(jt.astype(np.int64))
    jl, jc = j_prefill_chunked(jp, {"tokens": jnp.asarray(jt)}, jcfg, LONG_N_MAX, LONG_CHUNK)
    cl, cc = prefill_chunked(tp, {"tokens": tt}, cfg, LONG_N_MAX, LONG_CHUNK)
    wl, wc = prefill(tp, {"tokens": tt}, cfg, LONG_N_MAX)
    assert rel(cl, jl) <= JAX_TOL
    np.testing.assert_allclose(cl.numpy(), wl.numpy(), atol=SELF_TOL, rtol=SELF_TOL)
    for name, a, b in state_pairs(cc, jc):
        if name == "length":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert rel(a, b) <= JAX_TOL, (name, rel(a, b))
    for name, a, b in state_pairs(cc, wc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SELF_TOL, rtol=SELF_TOL,
                                   err_msg=name)


def test_linear_elu_chunks_decode_with_the_softmax_read(jax_params, rng):
    """linear_elu decodes by reading its KV cache with the exact softmax (as
    the JAX package does), and a chunk is decode steps token by token: its
    chunked logits and KV cache are the softmax model's prefill's."""
    _, cfg, _, tp = model(jax_params, "linear_elu")
    _, softmax_cfg, _, _ = model(jax_params, "softmax")
    _, tt = prompt(rng)
    cl, cc = prefill_chunked(tp, {"tokens": tt}, cfg, N_MAX, CHUNK)
    sl, sc = prefill(tp, {"tokens": tt}, softmax_cfg, N_MAX)
    np.testing.assert_allclose(cl.numpy(), sl.numpy(), atol=SELF_TOL, rtol=SELF_TOL)
    for name, a, b in state_pairs(cc, sc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=SELF_TOL, rtol=SELF_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["taylor", "softmax", "hybrid"])
def test_lm_prefill_chunk_takes_per_row_positions(jax_params, rng, case):
    """``pos0`` as a ``[b]`` vector: row 0 was prefilled with 16 tokens and
    row 1 with 8, and one batched chunk continues each at its own position.
    Each row matches a batch-1 run at its position, and the batch matches
    the JAX package's ``lm_prefill_chunk`` given the same vector."""
    jcfg, cfg, jp, tp = model(jax_params, case)
    jt, tt = prompt(rng)
    starts, c = (CHUNK, CHUNK // 2), 8
    caches = tlm.lm_init_caches(cfg, 2, N_MAX, device="cpu")
    jcaches = jlm.lm_init_caches(jcfg, 2, N_MAX, jnp.dtype(jcfg.dtype))
    solo = []
    for row, p0 in enumerate(starts):
        one = tlm.lm_init_caches(cfg, 1, N_MAX, device="cpu")
        _, one = tlm.lm_prefill_chunk(tp, tt[row:row + 1, :p0], one, 0, cfg)
        caches = tslots.write_slot(caches, one, row)
        jone = jlm.lm_init_caches(jcfg, 1, N_MAX, jnp.dtype(jcfg.dtype))
        _, jone = jlm.lm_prefill_chunk(jp, jnp.asarray(jt[row:row + 1, :p0]), jone, 0, jcfg)
        jcaches = jslots.write_slot(jcaches, jone, jnp.int32(row))
        solo.append(tlm.lm_prefill_chunk(tp, tt[row:row + 1, p0:p0 + c], one, p0, cfg))
    chunk = torch.stack([tt[row, p0:p0 + c] for row, p0 in enumerate(starts)])
    lv, cv = tlm.lm_prefill_chunk(tp, chunk, caches, torch.tensor(starts), cfg)
    jl, jc = jlm.lm_prefill_chunk(jp, jnp.asarray(chunk.numpy().astype(np.int32)), jcaches,
                                  jnp.asarray(starts, jnp.int32), jcfg)
    assert rel(lv, jl) <= JAX_TOL
    for name, a, b in state_pairs(cv, jc):
        assert rel(a, b) <= JAX_TOL, (name, rel(a, b))
    for row, (ls, cs) in enumerate(solo):
        assert rel(lv[row:row + 1], ls) <= JAX_TOL
        for name, a, b in state_pairs(tslots.read_slot(cv, row), cs):
            assert rel(a, b) <= JAX_TOL, (name, row, rel(a, b))


def test_prefill_chunked_rejects_bad_calls(jax_params, rng):
    _, cfg, _, tp = model(jax_params, "taylor")
    _, tt = prompt(rng)
    for chunk in (0, -4):
        with pytest.raises(ValueError, match="chunk must be >= 1"):
            prefill_chunked(tp, {"tokens": tt}, cfg, N_MAX, chunk)
    with pytest.raises(ValueError, match="decoder-only"):
        prefill_chunked(tp, {"tokens": tt}, cfg.replace(family="vlm"), N_MAX, CHUNK)
