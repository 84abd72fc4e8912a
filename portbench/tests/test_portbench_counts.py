"""The frozen work counts against the program's own: the Taylor kernels'
operations and bytes, their least times, and the models' parameters."""

import json

import pytest
import torch

from portbench import program
from portbench.counts import model, peaks, roofline, taylor
from portbench.tests.tiny import REPO, tiny_config
from repro_torch.analysis.roofline import bound_ms
from repro_torch.kernels.taylor_attention.cost import (
    BWD_TF32_PRODUCTS,
    FWD_TF32_PRODUCTS,
    taylor_bwd_cost,
    taylor_fwd_cost,
)
from repro_torch.models.config import count_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the port's zamba2-7b at its widths (2 of its 11 groups and the tail): a
# hybrid whose kernels run at head dim 112, which no cell runs yet
HYBRID = dict(d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336,
              vocab=32000, n_groups=2, context=4096, pattern=["mamba"] * 6 + ["shared_attn"],
              tail=["mamba"] * 4, ssm=dict(d_state=64, expand=2, head_dim=64, conv_width=4,
                                           n_groups=1))


def _config(name):
    if name == "hybrid":
        return dict(tiny_config("hybrid"), **HYBRID)
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def _launch(cfg, batch=1, seq=4096):
    """(bk, g, n, d, dv) of a training cell's launch."""
    hk = cfg["n_kv_heads"]
    return batch * hk, cfg["n_heads"] // hk, seq, cfg["head_dim"], cfg["head_dim"]


CELLS = ["granite-20b-x4", "hybrid"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_counts_equal_cost_at_chunk_64(name, itemsize):
    shape = _launch(_config(name))
    ops, _, nbytes = taylor_fwd_cost(*shape, taylor.CHUNK, itemsize)
    assert taylor.fwd(*shape, itemsize) == (ops, nbytes)
    cost = taylor_bwd_cost(*shape, taylor.CHUNK, itemsize)
    got = taylor.bwd(*shape, itemsize)
    for key, part in (("dq", "taylor_bwd_dq"), ("dkv", "taylor_bwd_dkv"), ("pair", "pair")):
        assert got[key] == (cost[part][0], cost[part][2])


@pytest.mark.parametrize("name", CELLS)
def test_least_time_within_the_programs_bound(name):
    """Every operation at the bf16 peak is never slower than the program's
    bound, which prices them at the TF32 and f32 rates."""
    shape = _launch(_config(name))
    ops, tensor, nbytes = taylor_fwd_cost(*shape, taylor.CHUNK, 2)
    least = peaks.least_seconds(*taylor.fwd(*shape, 2)) * 1e3
    assert least <= bound_ms(ops, nbytes, tensor, FWD_TF32_PRODUCTS["bfloat16"])[0]
    cost = taylor_bwd_cost(*shape, taylor.CHUNK, 2)
    for key, part in (("dq", "taylor_bwd_dq"), ("dkv", "taylor_bwd_dkv")):
        ops, tensor, nbytes = cost[part]
        least = peaks.least_seconds(*taylor.bwd(*shape, 2)[key]) * 1e3
        assert least <= bound_ms(ops, nbytes, tensor, BWD_TF32_PRODUCTS["bfloat16"])[0]


def test_launch_reads_the_models_head_dim():
    """The hybrid's kernels run q and k padded to 128; the count takes 112.
    The launch comes from the cell's batch and sequence, and a cell whose
    readings have none gives none."""
    layer = {"batch": 1, "seq": 4096}
    assert roofline.launch({"layer": layer, "config": _config("hybrid")}) == (
        32, 1, 4096, 112, 112)
    assert roofline.launch({"layer": layer, "config": _config("granite-20b-x4")}) == (
        1, 48, 4096, 128, 128)
    assert roofline.launch({"layer": {"stats": {}}, "config": _config("granite-20b-x4")}) is None


@pytest.mark.parametrize("name", CELLS)
def test_param_count_is_the_programs(name):
    cfg = _config(name)
    mc = program.model_config(cfg, {"dtype": "bfloat16", "param_dtype": "float32"})
    assert model.param_count(cfg) == count_params(mc)


@pytest.mark.parametrize("name", CELLS)
def test_matmul_params_are_the_programs_projections(name):
    """The matmul parameters per token are the program's parameters less
    the embedding and position tables, the norms, the biases and the SSD's per-head and
    conv leaves, with a shared block counted at each place it runs."""
    cfg = _config(name)
    mc = program.model_config(cfg, {"dtype": "bfloat16", "param_dtype": "float32"})
    kinds = cfg["pattern"] * cfg["n_groups"] + cfg["tail"]
    d, f = cfg["d_model"], cfg["d_ff"]
    per_norm = d * (2 if cfg["norm"] == "layernorm" else 1)   # scale (and bias)
    other = cfg["vocab"] * d + per_norm   # embedding, final norm
    if cfg["pos"] == "learned":
        other += cfg["context"] * d
    for kind in sorted(set(kinds)):
        count = kinds.count(kind) if kind != "shared_attn" else 1
        if kind == "mamba":
            s = cfg["ssm"]
            di = s["expand"] * d
            nh, conv = di // s["head_dim"], di + 2 * s["n_groups"] * s["d_state"]
            other += count * (per_norm + s["conv_width"] * conv + conv + 3 * nh + di)
        else:
            other += count * (2 * per_norm + (f + d if cfg["act"] == "gelu" else 0))
    shared = kinds.count("shared_attn")
    attn_matmul = (d * cfg["n_heads"] * cfg["head_dim"] * 2
                   + 2 * d * cfg["n_kv_heads"] * cfg["head_dim"]
                   + (2 if cfg["act"] == "gelu" else 3) * d * f)
    unique = model.matmul_params(cfg) - max(0, shared - 1) * attn_matmul
    assert unique == count_params(mc) - other


@pytest.mark.parametrize("name", CELLS)
def test_step_flops_count_attention_once(name):
    cfg = _config(name)
    shape = _launch(cfg)
    attn = taylor.fwd(*shape, 2)[0] + taylor.bwd(*shape, 2)["pair"][0]
    layers = sum(k != "mamba" for k in cfg["pattern"] * cfg["n_groups"] + cfg["tail"])
    assert model.train_step_flops(cfg, 1, 4096) == (
        6 * model.matmul_params(cfg) * 4096 + layers * attn)
