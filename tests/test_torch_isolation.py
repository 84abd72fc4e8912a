"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the CUDA device unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_reduced
from repro_torch.models import lm_init, lm_init_caches
from repro_torch.serve import ServeEngine, generate, generate_loop

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s+import)\b)", re.M
)


def test_importing_the_port_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(mods) >= 20


def test_training_modules_stand_alone():
    # the training modules are among those checked above, and none
    # of the port pulls in ml_dtypes (the JAX checkpoint store's bf16 codec)
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.core.taylor_vjp", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedules", "repro_torch.data.synthetic",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.checkpoint.store", "repro_torch.quickstart",
            "repro_torch.models.moe", "repro_torch.train_resume",
            "repro_torch.serve_longcontext", "repro_torch.configs.qwen2_1_5b",
            "repro_torch.configs.granite_20b", "repro_torch.configs.gemma_7b",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.kimi_k2_1t_a32b", "repro_torch.models.ssm",
            "repro_torch.backends.ssm", "repro_torch.configs.mamba2_780m",
            "repro_torch.configs.zamba2_7b", "repro_torch.configs.whisper_medium",
            "repro_torch.configs.llama_3_2_vision_11b", "repro_torch.launch.train",
            "repro_torch.checkpoint.from_jax", "repro_torch.distributed.spmd",
            "repro_torch.distributed.collectives", "repro_torch.distributed.sharding",
            "repro_torch.serve.scheduler", "repro_torch.analysis.roofline",
            "repro_torch.analysis.flops", "repro_torch.analysis.memory",
            "repro_torch.analysis.collectives", "repro_torch.analysis.report",
            "repro_torch.launch.dryrun",
            "repro_torch.kernels.taylor_attention.cost", "repro_torch.spans"} <= mods
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
        "sys.exit(1 if 'ml_dtypes' in sys.modules else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_or_repro():
    assert len(PORT_FILES) > 20
    for path in PORT_FILES:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)
    assert FORBIDDEN.search("from repro.core import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.core import x")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_init_caches(cfg, 1, 8)
    params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg, max_slots=1, n_max=8)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(params, batch, cfg, steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_loop(params, batch, cfg, steps=2)
