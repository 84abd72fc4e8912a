"""The port's serving path against the JAX package's, on the same weights.

Reduced smollm-135m, float32, greedy decoding: the port's ``generate`` and
``ServeEngine`` must produce exactly the tokens of the JAX package's
``generate`` and ``ServeEngine`` (token identity, no tolerance), with mixed
prompt lengths, more requests than slots, and an eos that retires a slot
early.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models.lm import lm_init as j_lm_init
from repro.serve import generate as j_generate
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine, generate, generate_loop
from repro_torch.serve import scheduler, slots


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_reduced("smollm-135m")
    cfg = get_reduced("smollm-135m")
    jp = j_lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def test_generate_token_identical_to_jax(weights, rng):
    jcfg, cfg, jp, tp = weights
    prompt = rng.integers(0, 128, (3, 20)).astype(np.int32)
    ref = np.asarray(j_generate(jp, {"tokens": jnp.asarray(prompt)}, jcfg, steps=10))
    batch = {"tokens": torch.from_numpy(prompt.astype(np.int64))}
    out = generate(tp, batch, cfg, steps=10, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    loop = generate_loop(tp, batch, cfg, steps=10, device="cpu")
    np.testing.assert_array_equal(loop.numpy(), out.numpy())


def test_generate_raises_when_a_request_fails(weights, rng, monkeypatch):
    """A decode error that outlives the engine's retries reaches the caller
    of ``generate`` with its cause, instead of a truncated result."""
    _, cfg, _, tp = weights

    def broken_decode(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(scheduler, "decode_scan", broken_decode)
    prompt = rng.integers(0, 128, (2, 12)).astype(np.int64)
    with pytest.raises(RuntimeError, match="ended failed.*device lost"):
        generate(tp, {"tokens": torch.from_numpy(prompt)}, cfg, steps=6, device="cpu")


def test_engine_token_identical_to_jax_engine(weights, rng):
    jcfg, cfg, jp, tp = weights
    lens = [12, 12, 20, 7, 30, 12]
    budgets = [6, 9, 5, 8, 7, 6]
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in lens]
    # eos for request 2: its third greedy token, so its slot retires early
    plain = generate_loop(tp, {"tokens": torch.from_numpy(prompts[2][None].astype(np.int64))},
                          cfg, steps=budgets[2], device="cpu")[0].numpy()
    eos = int(plain[2])
    first = int(np.flatnonzero(plain == eos)[0])
    eos_ids = [None, None, eos, None, None, None]

    jeng = JServeEngine(jp, jcfg, max_slots=2, n_max=64, decode_block=4)
    jrids = [jeng.submit(JRequest(tokens=p, max_new_tokens=m, eos_id=e))
             for p, m, e in zip(prompts, budgets, eos_ids)]
    jouts = jeng.run()
    teng = ServeEngine(tp, cfg, max_slots=2, n_max=64, decode_block=4, device="cpu")
    trids = [teng.submit(Request(tokens=p, max_new_tokens=m, eos_id=e))
             for p, m, e in zip(prompts, budgets, eos_ids)]
    touts = teng.run()
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(touts[tr], np.asarray(jouts[jr]))
    assert len(touts[trids[2]]) == first + 1 < budgets[2]
    assert touts[trids[2]][-1] == eos
    st = teng.stats()
    assert st["ok"] == len(lens)
    # FIFO admission: the two leading 12-token prompts share one prefill
    assert st["prefill_dispatches"] == len(lens) - 1


def test_engine_rejects_bad_requests(weights):
    _, cfg, _, tp = weights
    eng = ServeEngine(tp, cfg, max_slots=1, n_max=16, device="cpu")
    for req in (Request(tokens=np.zeros((0,), np.int64), max_new_tokens=2),
                Request(tokens=np.zeros((4,), np.int64), max_new_tokens=0),
                Request(tokens=np.zeros((10,), np.int64), max_new_tokens=7)):
        with pytest.raises(ValueError):
            eng.submit(req)


def test_slot_ops_round_trip(weights):
    _, cfg, _, _ = weights
    caches = slots.init_slot_caches(cfg, 3, 16, device="cpu")
    one = slots.read_slot(caches, 1)
    one["group"] = tuple(type(st)(*(x + 1.0 for x in st)) for st in one["group"])
    caches = slots.write_slot(caches, one, 1)
    back = slots.read_slot(caches, 1)
    for a, b in zip(back["group"][0], one["group"][0]):
        assert torch.equal(a, b)
    zero = slots.read_slot(caches, 0)
    assert all(float(x.abs().max()) == 0 for x in zero["group"][0])
    mask = torch.tensor([False, True, False])
    sel = slots.select_slots(mask, caches, slots.init_slot_caches(cfg, 3, 16, device="cpu"))
    assert float(slots.read_slot(sel, 1)["group"][0].s1.abs().max()) == 1.0
    cleared = slots.clear_slot(caches, 1)
    assert all(float(x.abs().max()) == 0 for x in slots.read_slot(cleared, 1)["group"][0])


def test_sample_tokens_greedy_top_k_and_temperature():
    from repro_torch.serve import sample_tokens

    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 0.0, 0.0, 4.9]])
    greedy = torch.tensor([1, 0])
    zero = torch.zeros(2)
    assert torch.equal(sample_tokens(logits, gen, zero, torch.zeros(2, dtype=torch.int64)),
                       greedy)
    # top_k = 1 leaves only the argmax, whatever the temperature
    one = torch.ones(2, dtype=torch.int64)
    for max_top_k in (None, 1, 4):
        out = sample_tokens(logits, gen, torch.full((2,), 5.0), one, max_top_k)
        assert torch.equal(out, greedy)
    # top_k = 2 at a high temperature draws only from the two largest logits
    draws = torch.stack([sample_tokens(logits, gen, torch.full((2,), 50.0),
                                       torch.full((2,), 2), 2) for _ in range(200)])
    assert set(draws[:, 0].tolist()) == {1, 3}
    assert set(draws[:, 1].tolist()) == {0, 3}


def test_engine_sampled_requests_are_seeded(weights, rng):
    _, cfg, _, tp = weights
    prompts = [rng.integers(0, 128, (n,)) for n in (9, 9, 14)]

    def run(seed):
        eng = ServeEngine(tp, cfg, max_slots=2, n_max=32, decode_block=4, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
        rids = [eng.submit(Request(tokens=p, max_new_tokens=6, temperature=1.0, top_k=8))
                for p in prompts]
        outs = eng.run()
        return [outs[r] for r in rids]

    a, b = run(3), run(3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert len(x) == 6 and ((0 <= x) & (x < 128)).all()
