"""Exact softmax attention baselines (PyTorch).

Two paths, as in the JAX package:
  * ``softmax_attention``       — the plain n×n form.
  * ``flash_softmax_attention`` — online softmax over key chunks, so the n²
    scores are never held at once; the same numerics.

Both take GQA heads (q ``[b, h, n, d]`` against k/v ``[b, hk, n, ·]``) and an
optional causal mask, and accumulate in float32.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def _group(q: Tensor, h_kv: int) -> Tensor:
    b, h, n, d = q.shape
    return q.reshape(b, h_kv, h // h_kv, n, d)


def softmax_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    kv_offset: int = 0,
) -> Tensor:
    """Reference softmax attention.  q: [b, h, nq, d]; k, v: [b, hk, nk, ·].

    ``kv_offset`` shifts query positions for decode: query i attends to
    keys j with j <= i + kv_offset.
    """
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bkgid,bkjd->bkgij", _group(q, h_kv).float(), k.float()) * scale
    if causal:
        iq = torch.arange(nq, device=q.device)[:, None] + kv_offset
        jk = torch.arange(nk, device=q.device)[None, :]
        s = s.masked_fill(jk > iq, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bkjv->bkgiv", p, v.float())
    return o.reshape(b, h, nq, v.shape[-1]).to(v.dtype)


def flash_softmax_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    chunk: int = 512,
) -> Tensor:
    """Online-softmax (flash-style) attention: a loop over key chunks with a
    running (max, sum, acc), O(n·chunk) scores live instead of O(n²).  Falls
    back to ``softmax_attention`` when ``chunk`` does not divide the keys."""
    b, h, nq, d = q.shape
    h_kv, nk = k.shape[1], k.shape[2]
    d_v = v.shape[-1]
    if nk % chunk != 0:
        return softmax_attention(q, k, v, causal=causal, scale=scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _group(q, h_kv).float()
    g = qg.shape[2]
    iq = torch.arange(nq, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, h_kv, g, nq), NEG_INF, **f32)
    l = torch.zeros((b, h_kv, g, nq), **f32)
    acc = torch.zeros((b, h_kv, g, nq, d_v), **f32)
    for c in range(nk // chunk):
        kc = k[:, :, c * chunk:(c + 1) * chunk].float()
        vc = v[:, :, c * chunk:(c + 1) * chunk].float()
        s = torch.einsum("bkgid,bkjd->bkgij", qg, kc) * scale
        if causal:
            jk = c * chunk + torch.arange(chunk, device=q.device)
            s = s.masked_fill(jk[None, :] > iq[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgij,bkjv->bkgiv", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, nq, d_v).to(v.dtype)


def softmax_decode_step(
    q_t: Tensor,
    k_cache: Tensor,
    v_cache: Tensor,
    length: Union[Tensor, int],
    scale: Optional[float] = None,
) -> Tensor:
    """One decode step against a (possibly not yet full) KV cache.

    q_t: [b, h, d]; k_cache/v_cache: [b, hk, n_max, ·]; ``length``: the
    number of valid cache entries, an int or one per row (the new token's
    k/v must already be written).
    """
    b, h, d = q_t.shape
    h_kv, n_max = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q_t.reshape(b, h_kv, h // h_kv, d)
    s = torch.einsum("bkgd,bkjd->bkgj", qg.float(), k_cache.float()) * scale
    length = torch.as_tensor(length, device=q_t.device).reshape(-1, 1)
    valid = torch.arange(n_max, device=q_t.device)[None, :] < length
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bkjv->bkgv", p, v_cache.float())
    return o.reshape(b, h, v_cache.shape[-1]).to(v_cache.dtype)
