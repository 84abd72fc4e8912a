"""Inference engine building blocks + generation wrappers.

The serving execution model is continuous batching (``scheduler.py``):
``max_slots`` requests decode together from a slot-indexed cache
(``slots.py``), and ``decode_scan`` advances ALL slots by a block of tokens
— a loop over ``lm_decode_step`` with per-slot position, stop and sampling
state, kept on the device until the block ends.  ``prefill_chunked`` is
the bounded-call admission path for long prompts.  ``generate`` wraps the
engine; ``generate_loop`` is the plain per-token loop kept as its oracle.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    lm_decode_step,
    lm_init_caches,
    lm_prefill,
    lm_prefill_chunk,
    tree_to,
)
from repro_torch.serve.slots import select_slots

Tensor = torch.Tensor


def prefill(params, batch: Dict[str, Tensor], cfg: ModelConfig, n_max: int):
    """Run the prompt; returns ``(logits [b, vocab]`` of the last prompt
    position``, caches)`` — every layer's decode state after the prompt
    (moment state or KV cache)."""
    return lm_prefill(params, batch, cfg, n_max)


def prefill_chunked(params, batch: Dict[str, Tensor], cfg: ModelConfig, n_max: int,
                    chunk: int):
    """Whole-prompt prefill as a sequence of bounded chunk calls.

    Same contract as ``prefill`` — ``(last-token logits [b, vocab],
    caches)``, matching it to fp tolerance — but no single call processes
    more than ``chunk`` prompt tokens: the serve engine's long-prompt
    admission path, between whose chunks in-flight slots keep decoding.

    Args:
      params: model params.
      batch: ``{"tokens": [b, n]}`` (decoder-only: no extras).
      cfg: model config (``family == "lm"``).
      n_max: per-slot KV capacity to allocate.
      chunk: prompt tokens per call (the last chunk may be shorter).

    Returns:
      ``(logits [b, vocab]`` of the last prompt position``, caches)``, on
      the tokens' device.
    """
    if cfg.family != "lm":
        raise ValueError(
            f"prefill_chunked supports decoder-only models; family "
            f"{cfg.family!r} prompts carry source extras that whole-prompt "
            "prefill must build (use prefill)"
        )
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    tokens = batch["tokens"]
    b, n = tokens.shape
    caches = lm_init_caches(cfg, b, n_max, tokens.device)
    logits = None
    for s in range(0, n, chunk):
        logits, caches = lm_prefill_chunk(params, tokens[:, s:s + chunk], caches, s, cfg)
    return logits, caches


def decode_step(params, token_t: Tensor, caches, pos, cfg: ModelConfig):
    """Advance one token for the whole batch: ``(logits [b, vocab], caches)``."""
    return lm_decode_step(params, token_t, caches, pos, cfg)


def sample_tokens(
    logits: Tensor,
    generator: Optional[torch.Generator],
    temperature: Tensor,
    top_k: Tensor,
    max_top_k: Optional[int] = None,
) -> Tensor:
    """Per-slot next-token sampling: greedy / temperature / top-k.

    Args:
      logits: ``[s, vocab]`` f32 next-token logits (one row per slot).
      generator: ``torch.Generator`` on logits' device for the draws.
      temperature: ``[s]`` f32; ``0`` selects greedy argmax for that slot.
      top_k: ``[s]`` int; ``> 0`` keeps only the k highest logits.
      max_top_k: upper bound on ``top_k``; ``0`` skips the filter, ``None``
        sorts the full vocabulary.

    Returns:
      ``[s]`` int64 tokens.
    """
    vocab = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    if max_top_k is None or max_top_k > 0:
        if max_top_k is None:
            desc = logits.sort(dim=-1, descending=True).values
        else:
            desc = logits.topk(min(max_top_k, vocab), dim=-1).values
        idx = (top_k.long() - 1).clamp(0, desc.shape[-1] - 1)[:, None]
        kth = desc.gather(-1, idx)
        drop = (top_k[:, None] > 0) & (logits < kth)
        logits = logits.masked_fill(drop, float("-inf"))
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    sampled = torch.multinomial(scaled.softmax(dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temperature > 0, sampled, greedy)


@torch.no_grad()
def decode_scan(
    params,
    caches,
    token: Tensor,
    pos: Tensor,
    active: Tensor,
    temperature: Tensor,
    top_k: Tensor,
    eos_id: Tensor,
    generator: Optional[torch.Generator],
    cfg: ModelConfig,
    steps: int,
    sampling: bool = True,
    max_top_k: Optional[int] = None,
    codec=None,
):
    """Advance every slot by ``steps`` tokens.

    Per step each ACTIVE slot feeds its current token at its own position,
    picks the next token and goes inactive when it emits its ``eos_id``.
    Inactive slots freeze (token/pos held), and slots inactive at the start
    keep their cache bit-identically.  Inside a serve engine's
    ``spmd.region`` the per-slot vectors stay whole on every rank, the
    model runs on this rank's slots (``spmd.rows``), and the logits are
    gathered whole (``spmd.all_rows``) before the next tokens are picked:
    one generator draws for every slot, as on one device.

    Args:
      params: model params.
      caches: slotted cache dict.
      token: ``[s]`` int64 current token per slot.
      pos: ``[s]`` int32 position of ``token`` per slot.
      active: ``[s]`` bool — slots that should decode.
      temperature: ``[s]`` f32 (0 = greedy).
      top_k: ``[s]`` int top-k filter (0 = off).
      eos_id: ``[s]`` int64 stop token (-1 = never stops).
      generator: generator for sampled slots.
      cfg: model config.
      steps: tokens to advance.
      sampling: False runs a pure-argmax loop (all slots greedy).
      max_top_k: bound on ``top_k`` (see ``sample_tokens``).
      codec: optional ``serve.state_repr`` codec: ``caches`` arrive and
        leave in its stored representation, decoded once before the block
        and re-encoded once after it (the cost is per block, not per
        token).

    Returns:
      ``(caches, token, pos, active, toks [steps, s], mask [steps, s])`` —
      ``toks[t, s]`` is valid output iff ``mask[t, s]``.  The input
      ``caches`` are not modified.
    """
    stored = caches
    if codec is not None:
        caches = codec.decode(stored)
    caches_in, active_in = caches, active
    toks, masks = [], []
    for _ in range(steps):
        logits, caches = lm_decode_step(params, spmd.rows(token), caches, spmd.rows(pos), cfg)
        logits = spmd.all_rows(logits)
        if sampling:
            nxt = sample_tokens(logits, generator, temperature, top_k, max_top_k)
        else:
            nxt = logits.argmax(dim=-1)
        nxt = torch.where(active, nxt, token)
        pos = torch.where(active, pos + 1, pos)
        masks.append(active)
        active = active & (nxt != eos_id)
        token = nxt
        toks.append(nxt)
    # Slots inactive at dispatch keep their state bit-identically: a slot a
    # speculative verify advanced this step is live but masked out here.
    caches = select_slots(spmd.rows(active_in), caches, caches_in)
    if codec is not None:
        caches = codec.encode(caches, stored)
    return caches, token, pos, active, torch.stack(toks), torch.stack(masks)


# ---------------------------------------------------------------------------
# Generation wrappers
# ---------------------------------------------------------------------------


def generate(
    params,
    batch: Dict[str, Tensor],
    cfg: ModelConfig,
    steps: int,
    n_max: Optional[int] = None,
    greedy: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tensor:
    """Greedy/sampled generation through the serve engine.

    Each batch row becomes one request, with its row of every extra input
    as ``Request.extras``; equal prompt lengths are admitted together and
    decode as one continuously batched group.

    Args:
      params: model params.
      batch: ``{"tokens": [b, n]}`` plus the family's extras
        (``image_embeds`` / ``audio_frames`` with a leading ``[b]`` axis).
      cfg: model config.
      steps: number of new tokens.
      n_max: context capacity (default ``prompt_len + steps``).
      greedy: argmax when True; otherwise temperature-1 sampling.
      generator: generator for sampled decoding (on the engine's device).
      device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Returns:
      ``[b, steps]`` int64 new tokens (on the CPU).

    Raises:
      RuntimeError: a request ended in another status than OK (a device
        error that survived the engine's retries), naming its error.
    """
    from repro_torch.serve.scheduler import Request, ServeEngine, Status  # noqa: PLC0415 (cycle)

    prompt = batch["tokens"].cpu()
    b, prompt_len = prompt.shape
    eng = ServeEngine(
        params, cfg, max_slots=b, n_max=n_max or (prompt_len + steps),
        decode_block=min(steps, 16) or 1, generator=generator, device=device,
    )
    temperature = 0.0 if (greedy or generator is None) else 1.0
    rids = [
        eng.submit(Request(tokens=prompt[i].numpy(), max_new_tokens=steps,
                           temperature=temperature,
                           extras={k: v[i:i + 1].cpu().numpy()
                                   for k, v in batch.items() if k != "tokens"}))
        for i in range(b)
    ]
    results = eng.run(return_results=True)
    for r in rids:
        if results[r].status is not Status.OK:
            raise RuntimeError(
                f"generate: request {r} ended {results[r].status.value}: {results[r].error}")
    return torch.stack([torch.as_tensor(results[r].tokens, dtype=torch.int64) for r in rids])


@torch.no_grad()
def generate_loop(
    params,
    batch: Dict[str, Tensor],
    cfg: ModelConfig,
    steps: int,
    n_max: Optional[int] = None,
    greedy: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tensor:
    """The plain per-token decode loop: the oracle for ``generate``.

    Same contract as ``generate``."""
    device = resolve_device(device)
    params = tree_to(params, device)
    batch = {k: v.to(device) for k, v in batch.items()}
    prompt_len = batch["tokens"].shape[1]
    n_max = n_max or (prompt_len + steps)
    logits, caches = lm_prefill(params, batch, cfg, n_max)
    outs = []
    token = logits.argmax(dim=-1)
    for i in range(steps):
        outs.append(token)
        if i == steps - 1:
            break
        logits, caches = lm_decode_step(params, token, caches, prompt_len + i, cfg)
        if greedy or generator is None:
            token = logits.argmax(dim=-1)
        else:
            token = torch.multinomial(logits.softmax(-1), 1, generator=generator)[:, 0]
    return torch.stack(outs, dim=1).cpu()
