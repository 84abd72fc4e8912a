"""The dry run (``repro_torch.launch.dryrun``) and the ``AbstractMesh``.

A rank's program traced on an ``AbstractMesh`` (meta tensors, no process
group) makes exactly the collectives that the same rank makes on a real
mesh: one ``gloo`` spawn of two ranks runs a reduced qwen2 training step on
tp 1×2 and a decode step on dp 2×1 and records them
(``collectives.recording``), against the abstract prediction for each
rank's coordinates, record for record.  The command line writes an ``ok``
record with the reference's keys for smollm-135m × train_4k on the 16×16
pod.  (The reference's own dry run is not run: it compiles for 256 forced
host devices; ``tests/test_torch_analysis.py`` holds the pieces.)
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.flops import trace
from repro_torch.configs import get_reduced
from repro_torch.data import make_task
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives as col
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, abstract_production_mesh, make_host_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.launch.train import make_sharded_state_and_step
from repro_torch.models.lm import lm_state_bytes
from repro_torch.optim import adamw, constant

ROOT = Path(__file__).resolve().parents[1]
B, N = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_reduced("qwen2-1.5b")


def _batch():
    task = make_task("bigram", _cfg().vocab, N, B, seed=0)
    return {k: torch.from_numpy(x) for k, x in task.batch_at(0).items()}


def _train(mesh, device):
    """tp training: the sharded step and its arguments on ``mesh``."""
    batch = _batch()
    if device == "meta":
        batch = {k: torch.empty_like(x, device="meta") for k, x in batch.items()}
    state, step, _, _ = make_sharded_state_and_step(
        _cfg(), adamw(constant(1e-3)), mesh, dist_api.rules_for_mesh(mesh), batch,
        device=device)
    return step, (state, batch)


def _decode(mesh, device):
    return dryrun.decode_program(_cfg(), mesh, dist_api.rules_for_mesh(mesh), B, N,
                                 device=torch.device(device))


def _ranks(rank, world):
    """Each rank's records of one tp 1×2 training step and one dp 2×1 decode
    step, in call order."""
    out = {}
    for name, build, mesh in (("train", _train, make_host_mesh(1, world, device="cpu")),
                              ("decode", _decode, make_host_mesh(world, 1, device="cpu"))):
        fn, args = build(mesh, "cpu")
        with col.recording() as log:
            fn(*args)
        out[name] = [tuple(r) for r in log]
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    return run_ranks(_ranks, 2, backend="gloo", init_file=str(tmp / "store"))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", ["train", "decode"])
def test_abstract_mesh_predicts_each_ranks_collectives(spawned, name, rank):
    coords = (0, rank) if name == "train" else (rank, 0)
    shape = (1, 2) if name == "train" else (2, 1)
    fn, args = (_train if name == "train" else _decode)(
        AbstractMesh(shape, ("data", "model"), coords), "meta")
    want = [tuple(r) for r in trace(fn, *args).records]
    got = spawned[rank][name]
    assert got == want
    kinds = {r[0] for r in got}
    if name == "train":  # heads over "model": gathers, reduce-scatters, the loss's sums
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
        sites = {r[3] for r in got}
        assert {"layer0/attn", "layer0/attn/bwd", "layer1/mlp", "mean_nll"} <= sites
        assert all(r[2] == 2 for r in got)
    else:  # slots over "data": the logits gathered whole
        assert ("all-gather", "all_rows") in {(r[0], r[3]) for r in got}


def test_abstract_mesh_collectives_communicate_nothing():
    mesh = AbstractMesh((2, 4), ("data", "model"), (1, 3))
    assert (mesh.size(), mesh.size(1), mesh.get_local_rank(0), col.axis_rank(mesh, "model"),
            col.axis_rank(mesh, ("data", "model"))) == (8, 4, 1, 3, 7)
    x = torch.ones(3, 8)
    before = dict(col.calls)
    with col.recording() as log, col.named("here"):
        g = col.gather_values(x, 1, mesh, "model")
        s = col.reduce_scatter(torch.ones(3, 8, requires_grad=True), 1, mesh, "model")
        r = col.all_reduce_values(x, mesh, ("data", "model"))
        a = col.all_to_all_values(x, 1, 0, mesh, "model")
        s.sum().backward()
    assert (g.shape, s.shape, r.shape, a.shape) == ((3, 32), (3, 2), (3, 8), (12, 2))
    assert [tuple(rec) for rec in log] == [
        ("all-gather", 3 * 32 * 4, 4, "here"), ("reduce-scatter", 3 * 2 * 4, 4, "here"),
        ("all-reduce", 3 * 8 * 4, 8, "here"), ("all-to-all", 12 * 2 * 4, 4, "here"),
        ("all-gather", 3 * 8 * 4, 4, "here/bwd")]
    assert col.calls["all_gather"] == before.get("all_gather", 0) + 2
    with pytest.raises(ValueError):
        AbstractMesh((2, 2), ("data", "model"), (0, 2))
    col.gather_values(x, 1, mesh, "model")
    assert len(log) == 5  # nothing records once the recording has ended


def test_decode_cell_counts_one_rank_of_the_pod():
    rec, records = dryrun.lower_cell("smollm-135m", "decode_32k", abstract_production_mesh())
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16" and rec["fits_hbm"]
    assert rec["decode_state_bytes"] == lm_state_bytes(dryrun.cell_config("smollm-135m"), 128,
                                                       32768)
    assert len(records) == rec["n_collectives"] > 0
    assert rec["cost"]["flops"] > 0 and rec["roofline"]["collective_s"] > 0


def test_dryrun_command_writes_an_ok_record():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m", "--shape",
         "train_4k", "--mesh", "pod", "--force"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    with open(dryrun.cell_path("smollm-135m", "train_4k", "16x16", None)) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["fits_hbm"] and rec["n_chips"] == 256
    assert {"arch", "shape", "backend", "mesh", "n_chips", "n_params", "n_active_params",
            "memory", "hbm_peak_bytes_per_chip", "fits_hbm", "cost", "roofline", "lower_s",
            "compile_s", "variant"} <= set(rec)
    ro = rec["roofline"]
    assert {"compute_s", "memory_s", "collective_s", "dominant", "flops_per_chip",
            "bytes_per_chip", "collective_link_bytes_per_chip", "t_lower_bound_s",
            "t_serial_s", "model_flops", "useful_flops_ratio", "roofline_fraction"} <= set(ro)
    # smollm's 9 heads do not split over 16: attention runs whole on every
    # rank, the sequence over "model" is gathered around each site
    assert ro["collective_breakdown"]["all-gather"]["link_bytes"] > 0
    assert ro["walker"]["matmul_flops"] > 0 and 0 < ro["useful_flops_ratio"] < 1
