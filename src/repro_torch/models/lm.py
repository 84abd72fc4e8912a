"""Model assembly: the decoder-only LM, the encoder-decoder (whisper-style)
and the VLM (cross-attention) families: init, full-sequence (training)
forward, prefill, chunked prefill and decode.

Params (the JAX package's names, one dict per layer instead of stacked
leaves)::

    {"embed": {"w": [vocab, d]}, "final_norm": {"scale": [d]},
     "blocks": [layer params, ...]}          # n_layers, group-major, then tail

(plus ``"unembed"`` when embeddings are untied, ``"pos_embed"`` [max_seq,
d] under ``pos="learned"``, ``"vision_proj"`` {"w": [vision_dim, d]} for a
vlm, ``"encoder"`` {"blocks": [...], "final_norm": ..., and under
``pos="learned"`` "pos_embed" [n_audio_ctx, d]} for an encdec model, and
``"shared"`` when the
pattern holds ``"shared_attn"`` blocks: that block's one set of weights,
used by every occurrence, whose ``"blocks"`` entries are ``None``.  So
every tree walk, the optimizer and ``count_params`` see each shared leaf
once, and autograd sums its gradient over the occurrences.  Zamba2's hybrid
sites (``cfg.sites``) add ``"shared_blocks"``, the list of the sites' shared
blocks, held once each in the same way, and ``"sites"``, each site's own
adapter and linear; ``lm_apply`` keeps the embedding output for them, and
they run in training only.)  Each layer runs under
its run's config view (``ModelConfig.layer_cfg`` of the backend that
``attention_schedule`` gives its pattern position; the tail under the
default), in one plain loop over the layers.  Decode caches keep the JAX
package's layout so the serve layer's slot operations and the parity tests
address them alike: one stacked state per run of ``schedule_runs``::

    {"group": (state with leaves [n_groups, run_len, b, ...] per run,),
     "tail": (state [b, ...] per tail block,), "kv_src": source or None}

where a state is the run's backend's NamedTuple (``TaylorState``,
``KVCache``, or a mamba block's ``MambaCache``), and for a cross block the
pair ``(self state, CrossCache)``; a hybrid schedule or a Mamba2 hybrid
gives a tuple of several.  ``kv_src`` is the cross-attention source ``[b,
m, d]`` of the vlm and encdec families (projected image tokens, encoder
output), carried for the slot operations.

Inputs are a dict ``{"tokens": [b, n] int64/int32}`` plus, for a vlm,
``"image_embeds"`` [b, n_image_tokens, vision_dim] (a stubbed vision
tower's output) and, for an encdec model, ``"audio_frames"`` [b,
n_audio_ctx, d_model] (a stubbed conv front end's output); training adds
``"labels"``.
"""

from __future__ import annotations

import contextvars
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch import spans
from repro_torch.backends import state_backend
from repro_torch.backends.state import CrossCache
from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.models.blocks import (
    block_apply,
    block_decode,
    block_init,
    block_prefill,
    block_prefill_chunk,
    hybrid_apply,
    shared_block_init,
    site_init,
)
from repro_torch.models.config import ModelConfig, schedule_runs
from repro_torch.models.layers import (
    dense_init,
    embed_apply,
    embed_init,
    norm_apply,
    norm_init,
    sinusoidal_pos,
    trunc_normal,
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


def _layers(params, cfg: ModelConfig):
    """``(kind, layer config, layer params)`` of every layer, in layer
    order; each shared_attn occurrence gets the one ``params["shared"]``."""
    return [(kind, lcfg, params["shared"] if kind == "shared_attn" else p)
            for (kind, lcfg), p in zip(_layer_cfgs(cfg), params["blocks"])]


def _no_sites(cfg: ModelConfig, where: str) -> None:
    """Zamba2's hybrid sites run in training on one device: raises for
    ``where``, another path."""
    if cfg.sites is not None:
        raise NotImplementedError(f"{cfg.name}: hybrid sites do not run {where}")


def _encoder_kinds(cfg: ModelConfig) -> List[str]:
    """The encoder's block kinds, in layer order (its pattern repeated
    ``n_encoder_groups`` times; every encoder layer runs the default
    backend)."""
    return list(cfg.encoder_pattern) * cfg.n_encoder_groups


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class MetaDraws:
    """Stands for a ``torch.Generator`` on the meta device: ``lm_init`` with it
    draws nothing and gives meta tensors of the params' shapes and dtypes
    (the reference's ``eval_shape`` of its init; the dry run's state)."""

    device = torch.device("meta")


def init_generator(seed: int, device: torch.device):
    """The generator that ``lm_init`` draws a model's weights with on
    ``device``: a seeded ``torch.Generator`` there, ``MetaDraws`` on meta."""
    if device.type == "meta":
        return MetaDraws()
    return torch.Generator(device=device).manual_seed(seed)


def lm_init(
    gen: torch.Generator,
    cfg: ModelConfig,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> Dict[str, Any]:
    """Random params from a seeded generator (the JAX package's shapes and
    init scales; not its random numbers).

    Args:
      gen: a seeded ``torch.Generator``.  Draws happen on its device: a
        CPU generator gives the same weights on every device, a CUDA one
        draws billions of parameters on the card in seconds; ``MetaDraws``
        gives the shapes alone.
      cfg: model config.
      dtype: param dtype (default ``cfg.param_dtype``).
      device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Returns:
      The param dict (see the module docstring) on ``device``.
    """
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, d, dtype),
        "final_norm": norm_init(d, cfg.norm, dtype),
        "blocks": [None if kind == "shared_attn" else block_init(gen, kind, lcfg, dtype)
                   for kind, lcfg in _layer_cfgs(cfg)],
    }
    if "shared_attn" in cfg.pattern + cfg.tail:
        params["shared"] = block_init(gen, "shared_attn", cfg, dtype)
    if cfg.sites is not None:
        params["shared_blocks"] = [shared_block_init(gen, cfg, dtype)
                                   for _ in range(cfg.sites.n_blocks)]
        params["sites"] = [site_init(gen, cfg, dtype) for _ in cfg.sites.layer_ids]
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab, d, dtype)
    if cfg.pos == "learned":
        params["pos_embed"] = trunc_normal(gen, (cfg.max_seq, d), 0.01, dtype)
    if cfg.family == "vlm":
        params["vision_proj"] = dense_init(gen, (cfg.vision_dim, d), dtype=dtype)
    if cfg.family == "encdec":
        params["encoder"] = {
            "blocks": [block_init(gen, kind, cfg, dtype) for kind in _encoder_kinds(cfg)],
            "final_norm": norm_init(d, cfg.norm, dtype),
        }
        if cfg.pos == "learned":
            params["encoder"]["pos_embed"] = trunc_normal(gen, (cfg.n_audio_ctx, d), 0.01,
                                                          dtype)
    return tree_to(params, device)


def tree_to(params, device):
    """Move every tensor of a param tree (nested dicts and lists) to ``device``."""
    return tree_map(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _embed_tokens(params, tokens: Tensor, cfg: ModelConfig,
                  positions: Optional[Tensor]) -> Tensor:
    """Token embeddings plus, under ``pos="learned"`` or ``"sinusoidal"``,
    the position embeddings of ``positions`` (any shape: ``[n]`` for a
    sequence, ``[b]`` or ``[1]`` for a decode step, ``[b, c]`` for a
    chunk; unread under RoPE, which attention applies)."""
    dtype = torch_dtype(cfg.dtype)
    x = embed_apply(spmd.on_rows(params["embed"]), tokens, dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dtype)
    if cfg.pos == "learned":
        x = x + spmd.on_rows(params["pos_embed"])[positions.long()].to(dtype)
    elif cfg.pos == "sinusoidal":
        pe = sinusoidal_pos(positions.reshape(-1), cfg.d_model)
        x = x + pe.reshape(positions.shape + (cfg.d_model,)).to(dtype)
    return x


def _encode(params, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """Whisper-style encoder over (stubbed) conv front-end frames: position
    embeddings, the non-causal encoder blocks, the encoder's final norm.
    Inside a mesh's region the encoder is a residual stream of its own
    length (``spmd.sequence``), and its output comes back whole along the
    sequence on this rank's rows."""
    dtype = torch_dtype(cfg.dtype)
    enc = params["encoder"]
    m = frames.shape[1]
    if cfg.pos == "learned":
        pe = spmd.on_rows(enc["pos_embed"])[:m]
    else:
        pe = sinusoidal_pos(torch.arange(m, device=frames.device), cfg.d_model)
    block = _remat(block_apply, cfg)
    with spmd.sequence(m):  # on a mesh: the encoder's stream, "sp" against m
        x = spmd.to_stream(frames.to(dtype) + pe.to(dtype)[None])
        for i, (kind, p) in enumerate(zip(_encoder_kinds(cfg), enc["blocks"])):
            with spmd.layer(f"encoder{i}"):
                x, _ = block(p, kind, x, cfg, None, None, False)
        x = norm_apply(spmd.on_stream(enc["final_norm"]), x, cfg.norm, cfg.norm_eps)
        return spmd.from_stream(x)


def _kv_source(params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Optional[Tensor]:
    """The cross blocks' source ``[b, m, d]``: the projected image tokens
    (vlm), the encoder's output (encdec), ``None`` for a decoder-only model."""
    if cfg.family == "vlm":
        img = batch["image_embeds"].to(torch_dtype(cfg.dtype))
        return img @ spmd.on_rows(params["vision_proj"])["w"].to(img.dtype)
    if cfg.family == "encdec":
        return _encode(params, batch["audio_frames"], cfg)
    return None


def _logits(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = norm_apply(spmd.on_stream(params["final_norm"]), x, cfg.norm, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed_apply(spmd.on_stream(table), x)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _dots_saveable():
    """``jax.checkpoint_policies.dots_saveable`` for torch's selective
    checkpoint: the outputs of matrix products are saved, every other op of
    the block is recomputed in the backward.  The products are the aten ops
    that ``torch.matmul``, ``F.linear`` and ``torch.einsum`` lower to: mm,
    bmm, addmm, baddbmm.  A Taylor kernel launch is no product: it reruns,
    as a ``pallas_call`` does under the reference's policy."""
    aten = torch.ops.aten
    ops = [aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default]
    return create_selective_checkpoint_contexts(ops)


def _remat(fn, cfg: ModelConfig):
    """Per-block rematerialisation: under ``remat="full"`` a block keeps only
    its input for the backward and reruns itself there; under
    ``"dots_saveable"`` it keeps its matrix products' outputs too.  The
    rerun sees the context variables of the first run (a mesh's
    ``spmd.region``): on a card the backward runs on another thread."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "dots_saveable"):
        raise ValueError(cfg.remat)
    extra = {"context_fn": _dots_saveable} if cfg.remat == "dots_saveable" else {}

    def run(*args):
        ctx = contextvars.copy_context()
        return checkpoint(lambda *a: ctx.run(fn, *a), *args, use_reentrant=False, **extra)

    return run


def lm_apply(params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Full training/eval forward.  Returns (logits [b, n, vocab] f32, aux).

    Differentiable w.r.t. the params; run it under ``torch.no_grad()`` for
    inference.  Inside a mesh's ``distributed.spmd.region`` ``params`` are
    this rank's blocks, ``batch`` its rows, and the logits its block
    ``("dp", "sp", None)``."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = spmd.to_stream(_embed_tokens(params, tokens, cfg, positions))
    kv_src = _kv_source(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    block = _remat(block_apply, cfg)
    sites = cfg.site_of_layer
    if sites:
        if spmd.in_region():
            _no_sites(cfg, "on a mesh")
        x0, hybrid = x, _remat(hybrid_apply, cfg)  # the sites read the embeddings
    for i, (kind, lcfg, p) in enumerate(_layers(params, cfg)):
        with spmd.layer(f"layer{i}"):
            if i in sites:
                j = sites[i]
                x, a = hybrid(p, params["shared_blocks"][j % cfg.sites.n_blocks],
                              params["sites"][j], x, x0, lcfg, positions)
            else:
                x, a = block(p, kind, x, lcfg, positions, kv_src)
        aux = aux + a
    with spans.span("head"):  # the backward's head ends at x (spans.backward_end)
        logits = _logits(params, spans.backward_end(x, "head.bwd"), cfg)
    return logits, aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def _stack_states(states: List[Any], n_groups: int, per_group: int):
    """Per-layer states (group-major) -> leaves [n_groups, per_group, ...]
    (a cross block's pair stacked half by half)."""
    return tree_map(lambda *xs: torch.stack(xs).reshape((n_groups, per_group) + xs[0].shape),
                    *states)


def _run_offsets(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """``(offset in the pattern, run_len)`` of each run."""
    out, offset = [], 0
    for _, _, rl in schedule_runs(cfg):
        out.append((offset, rl))
        offset += rl
    return out


def _split_caches(caches, cfg: ModelConfig) -> List[Any]:
    """Inverse of ``_pack_caches``: one state per layer, in layer order."""
    out = []
    for gi in range(cfg.n_groups):
        for stacked, (_, rl) in zip(caches["group"], _run_offsets(cfg)):
            for r in range(rl):
                out.append(tree_map(lambda x: x[gi, r], stacked))
    out.extend(caches["tail"])
    return out


def _pack_caches(states: List[Any], cfg: ModelConfig, kv_src: Optional[Tensor] = None):
    """Per-layer states (layer order) -> one stacked state per run, and the
    cross source ``kv_src``."""
    per_group = len(cfg.pattern)
    group = tuple(
        _stack_states([states[gi * per_group + offset + r]
                       for gi in range(cfg.n_groups) for r in range(rl)],
                      cfg.n_groups, rl)
        for offset, rl in _run_offsets(cfg)
    ) if cfg.n_groups else ()
    n_group_layers = cfg.n_groups * per_group
    return {"group": group, "tail": tuple(states[n_group_layers:]), "kv_src": kv_src}


@torch.no_grad()
def lm_prefill(params, batch: Dict[str, Tensor], cfg: ModelConfig, n_max: int):
    """Prompt pass (``batch`` carries the family's source extras).  Returns
    (logits of the last position [b, vocab], caches)."""
    _no_sites(cfg, "in serving")
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed_tokens(params, tokens, cfg, positions)
    kv_src = _kv_source(params, batch, cfg)
    states = []
    for i, (kind, lcfg, p) in enumerate(_layers(params, cfg)):
        with spmd.layer(f"layer{i}"):
            x, c = block_prefill(p, kind, x, lcfg, n_max, positions, kv_src)
        states.append(c)
    logits = _logits(params, x[:, -1:, :], cfg)[:, 0, :]
    return logits, _pack_caches(states, cfg, kv_src)


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
    _no_sites(cfg, "in serving")
    pos_t = None
    if cfg.pos in ("learned", "sinusoidal"):  # [b] or [1]
        pos_t = torch.as_tensor(pos, device=token_t.device).reshape(-1)
    x_t = _embed_tokens(params, token_t, cfg, pos_t)
    new_states = []
    for i, ((kind, lcfg, p), c) in enumerate(zip(_layers(params, cfg),
                                                 _split_caches(caches, cfg))):
        with spmd.layer(f"layer{i}"):
            x_t, c = block_decode(p, kind, x_t, c, lcfg, pos)
        new_states.append(c)
    logits = _logits(params, x_t, cfg)
    return logits, _pack_caches(new_states, cfg, caches.get("kv_src"))


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


@torch.no_grad()
def lm_verify_chunk(params, tokens: Tensor, caches, pos0, cfg: ModelConfig):
    """Advance the decode caches by a chunk, returning EVERY position's logits.

    The speculative-verify primitive: the state roll-forward of
    ``lm_prefill_chunk`` (the same chunk maths, so the returned caches are
    the state token-by-token decode would have built, to fp tolerance), with
    the logits head applied to all ``c`` positions.  The caller compares
    ``argmax(logits[:, j])`` with the drafted token at position ``j + 1``.

    Args:
      params: model params.
      tokens: ``[b, c]`` window: the last emitted token followed by the
        ``c - 1`` drafted tokens.
      caches: cache dict whose state has absorbed positions ``[0, pos0)``;
        not modified.
      pos0: int or ``[b]`` tensor — absolute position of ``tokens[:, 0]``.
      cfg: model config.

    Returns:
      ``(logits [b, c, vocab]`` for every window position``, new caches)``.
    """
    x, new = _chunk_hidden(params, tokens, caches, pos0, cfg)
    return _logits(params, x, cfg), new


def _chunk_hidden(params, tokens: Tensor, caches, pos0, cfg: ModelConfig):
    """The chunk-advance body: hidden states ``[b, c, d]`` and new caches,
    each layer under its run's config."""
    _no_sites(cfg, "in serving")
    b, c = tokens.shape
    positions = (
        torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device).expand(b)[:, None]
        + torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
    )  # [b, c]
    x = _embed_tokens(params, tokens, cfg, positions)
    new_states = []
    for i, ((kind, lcfg, p), cch) in enumerate(zip(_layers(params, cfg),
                                                   _split_caches(caches, cfg))):
        with spmd.layer(f"layer{i}"):
            x, cch = block_prefill_chunk(p, kind, x, cch, lcfg, positions)
        new_states.append(cch)
    return x, _pack_caches(new_states, cfg, caches.get("kv_src"))


def lm_init_caches(cfg: ModelConfig, batch: int, n_max: int, device=None):
    """Zero decode caches with the exact structure ``lm_prefill`` produces
    (KV leaves, a mamba block's conv window and ``kv_src`` in ``cfg.dtype``,
    the activations' dtype).  Each run's state comes from its own backend (a
    mamba run's from the block-level "ssm" one), so a hybrid schedule or a
    Mamba2 hybrid gives a tuple of different state types; a cross block's
    is the pair of its self state and a zero ``CrossCache`` of the source
    length."""
    _no_sites(cfg, "in serving")
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    n_src = cfg.n_source_tokens

    def one(kind, rcfg):
        backend = state_backend(kind, rcfg)
        state = backend.init_cache(rcfg, batch, n_max, device, dtype)
        if kind != "cross":
            return state
        return state, CrossCache(kv=backend.init_cross_cache(rcfg, batch, n_src, device, dtype))

    def stack(state, rl):
        return tree_map(lambda x: x.expand((cfg.n_groups, rl) + x.shape).clone(), state)

    group = tuple(stack(one(kind, rcfg), rl) for kind, rcfg, rl in _cfg_runs(cfg)) \
        if cfg.n_groups else ()
    tail_cfg = cfg.layer_cfg(cfg.attention)
    kv_src = None
    if cfg.family != "lm":
        kv_src = torch.zeros((batch, n_src, cfg.d_model), dtype=dtype, device=device)
    return {"group": group, "tail": tuple(one(kind, tail_cfg) for kind in cfg.tail),
            "kv_src": kv_src}


def lm_state_bytes(cfg: ModelConfig, batch: int, n_max: int) -> int:
    """Decode-state bytes of the whole cache, summed per layer, each run
    with its own backend's state (taylor moments and SSM states O(1), a
    softmax KV cache O(n_max), a softmax_window ring O(window)), with the
    cross blocks' source states and ``kv_src``; KV leaves, conv windows and
    ``kv_src`` in ``cfg.dtype``.

    Shapes only: the cache is built on the ``meta`` device, so nothing is
    allocated on the card."""
    caches = lm_init_caches(cfg, batch, n_max, device="meta")
    return sum(x.numel() * x.element_size() for x in tree_leaves(caches))
