"""Decoder-only LM: init, full-sequence (training) forward, prefill and decode.

Params (the JAX package's names, one dict per layer instead of stacked
leaves)::

    {"embed": {"w": [vocab, d]}, "final_norm": {"scale": [d]},
     "blocks": [layer params, ...]}          # n_layers, group-major, then tail

(plus ``"unembed"`` when embeddings are untied).  Decode caches keep the
JAX package's layout so the serve layer's slot operations and the parity
tests address them alike::

    {"group": (state with leaves [n_groups, len(pattern), b, ...],),
     "tail": (state [b, ...] per tail block,), "kv_src": None}

where a state is the backend's NamedTuple (``TaylorState`` or ``KVCache``).

Inputs are a dict ``{"tokens": [b, n] int64/int32}``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backends import resolve_backend
from repro_torch.device import resolve_device
from repro_torch.models.blocks import block_apply, block_decode, block_init, block_prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    unembed_apply,
)
from repro_torch.tree import tree_map

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig dtype name -> torch dtype."""
    return _DTYPES[name]


def _layer_kinds(cfg: ModelConfig) -> List[str]:
    return list(cfg.pattern) * cfg.n_groups + list(cfg.tail)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def lm_init(
    gen: torch.Generator,
    cfg: ModelConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Dict[str, Any]:
    """Random params from a seeded generator (the JAX package's shapes and
    init scales; not its random numbers).

    Args:
      gen: a seeded CPU ``torch.Generator``.  Draws happen on the CPU, so
        one seed gives the same weights on every device.
      cfg: model config.
      dtype: param dtype (default ``cfg.param_dtype``).
      device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Returns:
      The param dict (see the module docstring) on ``device``.
    """
    device = resolve_device(device)
    if cfg.family != "lm":
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported to torch")
    dtype = dtype or torch_dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": norm_init(cfg.d_model, dtype),
        "blocks": [block_init(gen, kind, cfg, dtype) for kind in _layer_kinds(cfg)],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype)
    return tree_to(params, device)


def tree_to(params, device):
    """Move every tensor of a param tree (nested dicts and lists) to ``device``."""
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed_tokens(params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    dtype = torch_dtype(cfg.dtype)
    x = embed_apply(params["embed"], tokens, dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype)
    if cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"pos {cfg.pos!r} is not yet ported to torch")
    return x


def _logits(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed_apply(table, x)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _remat(fn, cfg: ModelConfig):
    """Per-block rematerialisation: under ``remat="full"`` a block keeps only
    its input for the backward and reruns itself there."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise NotImplementedError(f"remat={cfg.remat!r} is not yet ported to torch")


def lm_apply(params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Full training/eval forward.  Returns (logits [b, n, vocab] f32, aux).

    Differentiable w.r.t. the params; run it under ``torch.no_grad()`` for
    inference."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    block = _remat(block_apply, cfg)
    for kind, p in zip(_layer_kinds(cfg), params["blocks"]):
        x, a = block(p, kind, x, cfg, positions)
        aux = aux + a
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def _stack_states(states: List[NamedTuple], n_groups: int, per_group: int) -> NamedTuple:
    """Per-layer states (group-major) -> leaves [n_groups, per_group, ...]."""
    return type(states[0])(*(
        None if leaves[0] is None
        else torch.stack(leaves).reshape((n_groups, per_group) + leaves[0].shape)
        for leaves in zip(*states)
    ))


def _split_caches(caches, cfg: ModelConfig) -> List[NamedTuple]:
    """Inverse of ``_pack_caches``: one state per layer, in layer order."""
    out = []
    if cfg.n_groups:
        (stacked,) = caches["group"]
        for gi in range(cfg.n_groups):
            for r in range(len(cfg.pattern)):
                out.append(type(stacked)(*(None if x is None else x[gi, r]
                                           for x in stacked)))
    out.extend(caches["tail"])
    return out


def _pack_caches(states: List[NamedTuple], cfg: ModelConfig):
    n_group_layers = cfg.n_groups * len(cfg.pattern)
    group = ()
    if cfg.n_groups:
        group = (_stack_states(states[:n_group_layers], cfg.n_groups, len(cfg.pattern)),)
    return {"group": group, "tail": tuple(states[n_group_layers:]), "kv_src": None}


@torch.no_grad()
def lm_prefill(params, batch: Dict[str, Tensor], cfg: ModelConfig, n_max: int):
    """Prompt pass.  Returns (logits of the last position [b, vocab], caches)."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    states = []
    for kind, p in zip(_layer_kinds(cfg), params["blocks"]):
        x, c = block_prefill(p, kind, x, cfg, n_max, positions)
        states.append(c)
    logits = _logits(params, x[:, -1:, :], cfg)[:, 0, :]
    return logits, _pack_caches(states, cfg)


@torch.no_grad()
def lm_decode_step(params, token_t: Tensor, caches, pos, cfg: ModelConfig):
    """One decode step.

    Args:
      params: model params.
      token_t: ``[b]`` current tokens.
      caches: cache dict (``lm_prefill`` / ``lm_init_caches`` layout).
      pos: int or ``[b]`` tensor — 0-based position of ``token_t`` (a vector
        gives every batch row / serving slot its own position).
      cfg: model config.

    Returns:
      ``(logits [b, vocab] f32, new caches)``; ``caches`` is not modified.
    """
    x_t = _embed_tokens(params, token_t, cfg)
    new_states = []
    for kind, p, c in zip(_layer_kinds(cfg), params["blocks"], _split_caches(caches, cfg)):
        x_t, c = block_decode(p, kind, x_t, c, cfg, pos)
        new_states.append(c)
    logits = _logits(params, x_t, cfg)
    return logits, _pack_caches(new_states, cfg)


def lm_init_caches(cfg: ModelConfig, batch: int, n_max: int, device=None):
    """Zero decode caches with the exact structure ``lm_prefill`` produces
    (KV leaves in ``cfg.dtype``, the activations' dtype)."""
    device = resolve_device(device)
    backend = resolve_backend(cfg)
    dtype = torch_dtype(cfg.dtype)
    states = [backend.init_cache(cfg, batch, n_max, device, dtype)
              for _ in _layer_kinds(cfg)]
    return _pack_caches(states, cfg)
