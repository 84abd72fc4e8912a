"""Architecture registry of the port, and the assigned input shapes.

Each ``configs/<arch>.py`` exports ``CONFIG`` (the published config) and
``reduced()`` (a tiny same-family config for CPU tests), with the JAX
package's values.  ``ARCHS`` lists all ten architectures of the JAX
package's registry, in its order: the dense, MoE and Mamba2 decoders, the
encoder-decoder whisper-medium and the VLM llama-3.2-vision-11b.

Shapes (the reference's): every LM-family arch is paired with all four —
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> serve prefill
  decode_32k   seq 32768,  global_batch 128  -> serve decode (1 token, cache)
  long_500k    seq 524288, global_batch 1    -> serve decode; requires
               sub-quadratic attention (taylor backend / SSM) — skipped for
               pure softmax configs.
``input_specs`` gives their inputs as ``TensorSpec``s, from which the dry
run (``launch/dryrun.py``) makes meta tensors.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

ARCHS = (
    "zamba2-7b",
    "granite-20b",
    "qwen2-1.5b",
    "gemma-7b",
    "smollm-135m",
    "kimi-k2-1t-a32b",
    "qwen2-moe-a2.7b",
    "whisper-medium",
    "mamba2-780m",
    "llama-3.2-vision-11b",
)


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r} (have {ARCHS})")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}"
    )


def get_config(arch: str, backend: Optional[str] = None, **overrides) -> ModelConfig:
    """Full published config, with ``overrides`` replaced.  ``backend``
    overrides the attention backend ("softmax" = the architecture's own
    baseline, "taylor" = the paper's technique applied to it)."""
    cfg = _module(arch).CONFIG
    if backend is not None:
        cfg = cfg.replace(attention=backend)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def get_reduced(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).reduced()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype without its data (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def empty(self) -> torch.Tensor:
        """An uninitialised meta tensor of this spec (a fake one when called
        under a ``FakeTensorMode``)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def applicable_shapes(cfg: ModelConfig) -> tuple:
    """Which assigned shapes are well-defined for this config."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return tuple(out)


def input_specs(cfg: ModelConfig, shape: str, reduced_batch: Optional[int] = None):
    """``TensorSpec``s of every model input of the given shape.

    For train/prefill this is the full batch with the family's source
    (the VLM's ``image_embeds``, whisper's ``audio_frames``); decode specs
    are the one-token inputs (the dry run builds the caches with
    ``lm_init_caches``)."""
    s = SHAPES[shape]
    b = reduced_batch or s.batch
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)

    def extras(batch_dims):
        e = {}
        if cfg.family == "vlm":
            e["image_embeds"] = TensorSpec(batch_dims + (cfg.n_image_tokens, cfg.vision_dim),
                                           act)
        if cfg.family == "encdec":
            e["audio_frames"] = TensorSpec(batch_dims + (cfg.n_audio_ctx, cfg.d_model), act)
        return e

    if s.kind == "train":
        return {
            "tokens": TensorSpec((b, s.seq), i32),
            "labels": TensorSpec((b, s.seq), i32),
            **extras((b,)),
        }
    if s.kind == "prefill":
        return {"tokens": TensorSpec((b, s.seq), i32), **extras((b,))}
    if s.kind == "decode":
        return {
            "token_t": TensorSpec((b,), i32),
            "pos": TensorSpec((), i32),
        }
    raise ValueError(shape)
