"""The control of each cell at a size a test run holds: the plain reference
put in the program's place and computed in the precision below the cell's
(fp8 products for bf16), judged by the cell's own limits, comes out not
correct.  On the card, at the cells' own sizes, ``tools/calibrate.py``
reads the same control (PERF.md gives its readings)."""

import pytest
import torch

from portbench.kinds import serve_open as serve
from portbench.kinds import train
from portbench.run import Harness
from portbench.tests import tiny
from portbench.tracing import Tracer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _harness(kind, config, seed):
    cell = tiny.tiny_cell(kind, config)
    return Harness(cell, tiny.tiny_config(config), seed, 2.0, torch.device("cpu"), Tracer(False))


@pytest.mark.parametrize("config", sorted(tiny.TINY))
@pytest.mark.parametrize("seed", [3_000_000_101, 3_000_000_102, 3_000_000_103])
def test_training_control_is_not_correct(config, seed):
    h = _harness("train", config, seed)
    batch = train._batches(h, h.cell["traffic"], h.config["vocab"])
    want = train.reference(h, h.config, h.cell, batch)
    control = train.numbers(train.reference(h, h.config, h.cell, batch, "fp8"), want)
    assert any(v > h.cell["limits"][k] for k, v in control.items()), control


@pytest.mark.parametrize("seed", [3_000_000_201, 3_000_000_202, 3_000_000_203])
def test_serving_control_is_not_correct(seed):
    """A few hundred served tokens over a vocabulary of 4096, where, as in
    the cell, near-ties at the top are common enough for fp8 to reorder."""
    h = _harness("serve", "granite-20b-x4", seed)
    h.config["vocab"] = 4096
    h.cell["traffic"].update(output={"dist": "uniform", "lo": 16, "hi": 32}, sample=8)
    h.seconds = 3.0
    out = serve.serve(h)
    picked = serve.sample(seed, out["done"], h.cell["traffic"]["sample"])
    gap = serve.reference_gap(h, h.config, picked, out["dtype"], quant="fp8")
    assert gap > h.cell["limits"]["logit_gap"], gap
