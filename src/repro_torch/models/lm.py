"""Decoder-only LM: init, full-sequence (training) forward, prefill, chunked
prefill and decode.

Params (the JAX package's names, one dict per layer instead of stacked
leaves)::

    {"embed": {"w": [vocab, d]}, "final_norm": {"scale": [d]},
     "blocks": [layer params, ...]}          # n_layers, group-major, then tail

(plus ``"unembed"`` when embeddings are untied).  Each layer runs under
its run's config view (``ModelConfig.layer_cfg`` of the backend that
``attention_schedule`` gives its pattern position; the tail under the
default), in one plain loop over the layers.  Decode caches keep the JAX
package's layout so the serve layer's slot operations and the parity tests
address them alike: one stacked state per run of ``schedule_runs``::

    {"group": (state with leaves [n_groups, run_len, b, ...] per run,),
     "tail": (state [b, ...] per tail block,), "kv_src": None}

where a state is the run's backend's NamedTuple (``TaylorState`` or
``KVCache``); a hybrid schedule gives a tuple of both.

Inputs are a dict ``{"tokens": [b, n] int64/int32}``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backends import resolve_backend
from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    block_apply,
    block_decode,
    block_init,
    block_prefill,
    block_prefill_chunk,
)
from repro_torch.models.config import ModelConfig, schedule_runs
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    unembed_apply,
)
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig dtype name -> torch dtype."""
    return _DTYPES[name]


def _cfg_runs(cfg: ModelConfig) -> List[Tuple[str, ModelConfig, int]]:
    """``(kind, run_cfg, run_len)`` per run of ``schedule_runs``: each run
    carries its uniform ``layer_cfg`` view."""
    return [(kind, cfg.layer_cfg(bk), rl) for kind, bk, rl in schedule_runs(cfg)]


def _layer_cfgs(cfg: ModelConfig) -> List[Tuple[str, ModelConfig]]:
    """``(kind, layer config)`` of every layer, in layer order (group-major,
    then the tail under the default backend)."""
    group = [(kind, rcfg) for kind, rcfg, rl in _cfg_runs(cfg) for _ in range(rl)]
    tail_cfg = cfg.layer_cfg(cfg.attention)
    return group * cfg.n_groups + [(kind, tail_cfg) for kind in cfg.tail]


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
        "blocks": [block_init(gen, kind, lcfg, dtype) for kind, lcfg in _layer_cfgs(cfg)],
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
    for (kind, lcfg), p in zip(_layer_cfgs(cfg), params["blocks"]):
        x, a = block(p, kind, x, lcfg, positions)
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


def _run_offsets(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """``(offset in the pattern, run_len)`` of each run."""
    out, offset = [], 0
    for _, _, rl in schedule_runs(cfg):
        out.append((offset, rl))
        offset += rl
    return out


def _split_caches(caches, cfg: ModelConfig) -> List[NamedTuple]:
    """Inverse of ``_pack_caches``: one state per layer, in layer order."""
    out = []
    for gi in range(cfg.n_groups):
        for stacked, (_, rl) in zip(caches["group"], _run_offsets(cfg)):
            for r in range(rl):
                out.append(type(stacked)(*(None if x is None else x[gi, r]
                                           for x in stacked)))
    out.extend(caches["tail"])
    return out


def _pack_caches(states: List[NamedTuple], cfg: ModelConfig):
    """Per-layer states (layer order) -> one stacked state per run."""
    per_group = len(cfg.pattern)
    group = tuple(
        _stack_states([states[gi * per_group + offset + r]
                       for gi in range(cfg.n_groups) for r in range(rl)],
                      cfg.n_groups, rl)
        for offset, rl in _run_offsets(cfg)
    ) if cfg.n_groups else ()
    n_group_layers = cfg.n_groups * per_group
    return {"group": group, "tail": tuple(states[n_group_layers:]), "kv_src": None}


@torch.no_grad()
def lm_prefill(params, batch: Dict[str, Tensor], cfg: ModelConfig, n_max: int):
    """Prompt pass.  Returns (logits of the last position [b, vocab], caches)."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    states = []
    for (kind, lcfg), p in zip(_layer_cfgs(cfg), params["blocks"]):
        x, c = block_prefill(p, kind, x, lcfg, n_max, positions)
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
    for (kind, lcfg), p, c in zip(_layer_cfgs(cfg), params["blocks"],
                                  _split_caches(caches, cfg)):
        x_t, c = block_decode(p, kind, x_t, c, lcfg, pos)
        new_states.append(c)
    logits = _logits(params, x_t, cfg)
    return logits, _pack_caches(new_states, cfg)


@torch.no_grad()
def lm_prefill_chunk(params, tokens: Tensor, caches, pos0, cfg: ModelConfig):
    """Advance the decode caches by a CHUNK of prompt tokens.

    ``lm_decode_step`` widened to ``c`` tokens: the caller loops it over a
    long prompt so that no single call exceeds the chunk budget.  Starting
    from ``lm_init_caches`` zeros and feeding the whole prompt chunk by chunk
    reproduces ``lm_prefill``'s logits and final state to fp tolerance.

    Args:
      params: model params.
      tokens: ``[b, c]`` chunk of prompt tokens.
      caches: cache dict from ``lm_init_caches`` (first chunk) or the
        previous ``lm_prefill_chunk`` call; not modified.
      pos0: int or ``[b]`` tensor — absolute position of ``tokens[:, 0]``.
      cfg: model config.

    Returns:
      ``(logits [b, vocab]`` of the chunk's LAST token``, new caches)``.
    """
    x, new = _chunk_hidden(params, tokens, caches, pos0, cfg)
    return _logits(params, x[:, -1:, :], cfg)[:, 0, :], new


def _chunk_hidden(params, tokens: Tensor, caches, pos0, cfg: ModelConfig):
    """The chunk-advance body: hidden states ``[b, c, d]`` and new caches,
    each layer under its run's config."""
    b, c = tokens.shape
    positions = (
        torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device).expand(b)[:, None]
        + torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
    )  # [b, c]
    x = _embed_tokens(params, tokens, cfg)
    new_states = []
    for (kind, lcfg), p, cch in zip(_layer_cfgs(cfg), params["blocks"],
                                    _split_caches(caches, cfg)):
        x, cch = block_prefill_chunk(p, kind, x, cch, lcfg, positions)
        new_states.append(cch)
    return x, _pack_caches(new_states, cfg)


def lm_init_caches(cfg: ModelConfig, batch: int, n_max: int, device=None):
    """Zero decode caches with the exact structure ``lm_prefill`` produces
    (KV leaves in ``cfg.dtype``, the activations' dtype).  Each run's state
    comes from its own backend, so a hybrid schedule gives a tuple of
    different state types."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def one(rcfg):
        return resolve_backend(rcfg).init_cache(rcfg, batch, n_max, device, dtype)

    def stack(state, rl):
        return tree_map(lambda x: x.expand((cfg.n_groups, rl) + x.shape).clone(), state)

    group = tuple(stack(one(rcfg), rl) for _, rcfg, rl in _cfg_runs(cfg)) \
        if cfg.n_groups else ()
    tail_cfg = cfg.layer_cfg(cfg.attention)
    return {"group": group, "tail": tuple(one(tail_cfg) for _ in cfg.tail), "kv_src": None}


def lm_state_bytes(cfg: ModelConfig, batch: int, n_max: int) -> int:
    """Decode-state bytes of the whole cache, summed per layer, each run
    with its own backend's state (taylor moments O(1), a softmax KV cache
    O(n_max), a softmax_window ring O(window)); KV leaves in ``cfg.dtype``.

    Shapes only: the cache is built on the ``meta`` device, so nothing is
    allocated on the card."""
    caches = lm_init_caches(cfg, batch, n_max, device="meta")
    return sum(x.numel() * x.element_size() for x in tree_leaves(caches))
