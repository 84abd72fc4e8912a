"""Zamba2-7B-Instruct's layout in the port (``configs/zamba2_7b_instruct.py``)
on the CPU: its parameter counts, the hybrid sites' pieces (the grouped gate
norm, the exact-GELU MLP with its adapter, the widened attention), the
training step through ``make_train_step`` and ``lm_apply`` with and without
a donated state, its spans, and the paths it does not run."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs import ARCHS
from repro_torch.configs import zamba2_7b_instruct as z
from repro_torch.models import count_params, lm_init, lm_init_caches, lm_prefill
from repro_torch.models import ssm
from repro_torch.models.config import SiteConfig
from repro_torch.models.layers import mlp_apply, norm_apply
from repro_torch.optim import adamw, constant, sgdm
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves

STAGE = z.CONFIG.replace(n_groups=27, sites=dataclasses.replace(z.CONFIG.sites,
                                                                 layer_ids=(6, 11, 17, 23)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, cfg.vocab, (2, n + 1), generator=g)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def test_counts_are_the_release_and_the_stage():
    assert count_params(z.CONFIG) == 7_356_749_648
    assert count_params(STAGE) == 2_968_362_608
    cfg = z.reduced()
    params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert sum(p.numel() for p in tree_leaves(params)) == count_params(cfg)
    assert len(params["shared_blocks"]) == 2 and len(params["sites"]) == 4
    assert params["shared_blocks"][0]["attn"]["wq"]["w"].shape == (128, 4, 32)
    assert params["shared_blocks"][0]["attn"]["wo"]["w"].shape == (4, 32, 64)
    assert params["sites"][0]["adapter"]["b"].shape == (4, 2 * cfg.d_ff)


def test_the_release_stays_out_of_the_registry():
    assert "zamba2-7b-instruct" not in ARCHS and len(ARCHS) == 10
    assert z.CONFIG.attention_width == 7168 and z.CONFIG.n_layers == 81
    assert z.CONFIG.site_of_layer[23] == 3 and len(z.CONFIG.site_of_layer) == 13


@pytest.mark.parametrize("bad", [
    dict(sites=SiteConfig(layer_ids=(3, 1))),
    dict(sites=SiteConfig(layer_ids=(81,))),
    dict(sites=SiteConfig(layer_ids=(1,), n_blocks=0)),
    dict(pattern=("mamba", "attn"), n_groups=40),
    dict(act="gelu"),
    dict(head_dim=112),
])
def test_a_site_layout_that_cannot_be_is_refused(bad):
    with pytest.raises(ValueError):
        z.CONFIG.replace(**bad)


def test_grouped_gate_norm_is_the_old_norm_at_one_group():
    cfg = z.reduced()
    y = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(3)) * 3
    scale = {"scale": torch.rand(128, generator=torch.Generator().manual_seed(4)) + 0.5}
    one = cfg.replace(ssm=dataclasses.replace(cfg.ssm, n_groups=1), norm_eps=1e-6)
    assert torch.equal(ssm.gate_norm(scale, y, one), norm_apply(scale, y, "rmsnorm"))
    got = ssm.gate_norm(scale, y, cfg)
    halves = [h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-5) for h in y.chunk(2, -1)]
    torch.testing.assert_close(got, torch.cat(halves, -1) * scale["scale"], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, norm_apply(scale, y, "rmsnorm", 1e-5), atol=1e-3)


def test_exact_gelu_mlp_takes_the_adapter_on_gate_and_up():
    g = torch.Generator().manual_seed(5)
    d, f, r = 8, 12, 3
    p = {"w_gate": torch.randn(d, f, generator=g), "w_up": torch.randn(d, f, generator=g),
         "w_down": torch.randn(f, d, generator=g)}
    ad = {"a": torch.randn(d, r, generator=g), "b": torch.randn(r, 2 * f, generator=g)}
    x = torch.randn(4, d, generator=g)
    gu = torch.cat([x @ p["w_gate"], x @ p["w_up"]], -1) + x @ ad["a"] @ ad["b"]
    want = (F.gelu(gu[:, :f]) * gu[:, f:]) @ p["w_down"]
    torch.testing.assert_close(mlp_apply(p, x, "geglu_erf", adapter=ad), want)
    plain = mlp_apply(p, x, "geglu_erf")
    assert not torch.allclose(plain, mlp_apply(p, x, "geglu"))  # erf, not tanh


def _state(cfg, opt, seed=0):
    params = lm_init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))


def test_a_donated_step_is_the_functional_step_bit_for_bit():
    """Three AdamW steps with the clip active, the donated state written in
    place, against the functional step's new tensors."""
    cfg = z.reduced().replace(remat="full")
    opt = adamw(constant(1e-3), clip_norm=0.1)
    kept, donated = _state(cfg, opt), _state(cfg, opt)
    plain, inplace = make_train_step(cfg, opt), make_train_step(cfg, opt, donate=True)
    leaves = tree_leaves(donated)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        kept, m1 = plain(kept, batch)
        donated, m2 = inplace(donated, batch)
        assert float(m1["loss"]) == float(m2["loss"])
    assert int(donated.step) == int(kept.step) == 3
    for a, b in zip(tree_leaves((kept.params, kept.opt_state)),
                    tree_leaves((donated.params, donated.opt_state))):
        assert torch.equal(a, b)
    # the donated step wrote into the tensors it was given
    assert all(x is y for x, y in zip(tree_leaves(donated.params), leaves[1:]))
    with pytest.raises(ValueError, match="update_in_place"):
        make_train_step(cfg, sgdm(constant(1e-3)), donate=True)


def test_the_step_learns_and_every_leaf_gets_a_gradient():
    cfg = z.reduced().replace(remat="full")
    opt = adamw(constant(3e-3))
    state = _state(cfg, opt)
    step = make_train_step(cfg, opt, donate=True)
    batch = _batch(cfg)
    state, first = step(state, batch)
    assert all(float(m.abs().max()) > 0 for m in tree_leaves(state.opt_state.m)
               if m.numel() > 1)
    for _ in range(8):
        state, last = step(state, batch)
    assert float(last["loss"]) < float(first["loss"]) - 0.5


def test_the_sites_run_in_training_only():
    cfg = z.reduced()
    params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="serving"):
        lm_prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)}, cfg, 16)
    with pytest.raises(NotImplementedError, match="serving"):
        lm_init_caches(cfg, 1, 16, device="cpu")


def test_the_new_spans_lie_where_their_readers_read_and_record_nothing_while_off():
    """Under remat "full" a step runs each site's scan and each mamba mixer
    twice (the forward and its rerun) and the scan's backward once; off,
    the spans record nothing."""
    from torch.profiler import ProfilerActivity, profile

    cfg = z.reduced().replace(remat="full")
    opt = adamw(constant(1e-3))
    state = _state(cfg, opt)
    step = make_train_step(cfg, opt, donate=True)
    spans.disable()
    spans.reset()
    state, _ = step(state, _batch(cfg))
    names = ("attention.scan", "attention.scan.bwd", "hybrid.pre", "hybrid.post", "mamba")
    assert not set(spans.snapshot()["spans"]) & set(names)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, _batch(cfg, seed=1))
    got = spans.snapshot()["spans"]
    sites, layers = len(cfg.sites.layer_ids), cfg.n_layers
    assert {n: got[n]["calls"] for n in names} == {
        "attention.scan": 2 * sites, "attention.scan.bwd": sites, "hybrid.pre": 2 * sites,
        "hybrid.post": 2 * sites, "mamba": 2 * layers}
    traced = {e.name for e in prof.events()}
    assert {spans.PREFIX + n for n in names} <= traced
    spans.reset()
