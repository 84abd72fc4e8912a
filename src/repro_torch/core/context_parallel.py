"""Context (sequence) parallelism for Taylor linear attention.

Ring attention for softmax moves O(n·d) KV blocks around the ring every
step.  The Taylor moments are *sums over positions*, so context
parallelism needs exactly ONE exchange of the constant-size state
(O(d²·d_v) per kv head, independent of sequence length):

  1. each shard runs the chunked scan over its local sequence slice with a
     zero initial state, producing local unnormalised (num, den) and its
     local state contribution;
  2. one all-gather of the per-shard states (the only collective: the
     state's leaves travel packed in one buffer);
  3. shard i adds the contraction of its queries against the *exclusive
     prefix sum* of earlier shards' states, then normalises.

Exact up to rounding (held to the unsharded chunked run and to the JAX
package's function).  ``taylor_cp_local`` is the per-rank body, which the
model's sharded path calls on its sequence blocks;
``taylor_attention_context_parallel`` takes whole tensors, as the
reference's does.
"""

from __future__ import annotations

import torch

from repro_torch.core.feature_map import TaylorConfig
from repro_torch.core.taylor import (
    TaylorState,
    _chunk_inter,
    _group,
    _norm_qk,
    _safe_div,
    _ungroup,
    chunked_num_den,
    init_taylor_state,
)
from repro_torch.distributed import api as dist
from repro_torch.distributed import collectives as col

Tensor = torch.Tensor


def attention_context_parallel(q: Tensor, k: Tensor, v: Tensor, cfg, mesh, axis: str,
                               dp_axis=None) -> Tensor:
    """Registry-dispatched context-parallel attention over whole tensors.

    Resolves ``cfg.attention`` (a ``ModelConfig``) through the backend
    registry, enforces the ``supports_cp`` capability flag and delegates to
    the backend's ``apply_cp``."""
    from repro_torch.backends.registry import resolve_backend  # noqa: PLC0415 (cycle)

    backend = resolve_backend(cfg)
    if not backend.supports_cp:
        raise ValueError(
            f"attention backend {backend.name!r} does not support context "
            "parallelism (supports_cp=False)"
        )
    return backend.apply_cp(q, k, v, cfg, mesh, axis, dp_axis=dp_axis)


def exchange(parts, mesh, axis: str) -> Tensor:
    """The one collective: every shard's tensors, packed along their last
    dim (same leading dims), gathered as ``[shards, ...]``."""
    packed = torch.cat(parts, dim=-1)
    return col.all_gather(packed[None], 0, mesh, axis, grad="sum")


def taylor_cp_local(q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig, mesh, axis: str,
                    chunk: int) -> Tensor:
    """One rank's context-parallel attention over its sequence block:
    q ``[b, h, n_loc, d]``, k/v ``[b, hk, n_loc, ·]``, the blocks of the
    ranks along ``axis`` in sequence order.  Returns ``[b, h, n_loc, dv]``."""
    bl, _, n_loc, d = q.shape
    h_kv, d_v = k.shape[1], v.shape[-1]
    if n_loc % chunk:
        raise ValueError(f"local sequence {n_loc} not a multiple of chunk {chunk}")
    qn, kn = _norm_qk(q, k, cfg)
    qg = _group(qn, h_kv)  # [bl, hk, g, n_loc, d]
    g = qg.shape[2]
    nc = n_loc // chunk
    qs = qg.reshape(bl, h_kv, g, nc, chunk, d).movedim(3, 0)
    ks = kn.reshape(bl, h_kv, nc, chunk, d).movedim(2, 0)
    vs = v.reshape(bl, h_kv, nc, chunk, d_v).movedim(2, 0)
    state0 = init_taylor_state(bl, h_kv, d, d_v, cfg, device=q.device)
    nums, dens, local = chunked_num_den(qs, ks, vs, cfg, state0)
    nums = nums.movedim(0, 3).reshape(bl, h_kv, g, n_loc, d_v)
    dens = dens.movedim(0, 3).reshape(bl, h_kv, g, n_loc)

    leaves = [s for s in local if s is not None]
    flat = [s.reshape(bl, h_kv, -1) for s in leaves]
    gathered = exchange(flat, mesh, axis)  # [S, bl, hk, Σ sizes]
    n_shards = gathered.shape[0]
    idx = col.axis_rank(mesh, axis)
    weights = (torch.arange(n_shards, device=q.device) < idx).float()
    prefix = torch.einsum("s,sbkf->bkf", weights, gathered)
    sizes = [f.shape[-1] for f in flat]
    it = iter(p.reshape(s.shape) for p, s in zip(prefix.split(sizes, dim=-1), leaves))
    state_in = TaylorState(*(None if s is None else next(it) for s in local))
    inum, iden = _chunk_inter(qg, state_in, cfg, cfg.scale(d))
    out = _safe_div(nums + inum, dens + iden)
    return _ungroup(out).to(v.dtype)


def taylor_attention_context_parallel(q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig,
                                      mesh, axis: str, chunk: int = 128,
                                      dp_axis=None) -> Tensor:
    """q: [b, h, n, d]; k/v: [b, hk, n, ·], whole and the same on every rank;
    the sequence is sharded over ``axis``, the batch over ``dp_axis`` where
    it divides (heads replicated within the sequence group).  Returns the
    whole output on every rank."""
    b, _, n, _ = q.shape
    n_shards = dist.mesh_axis_size(mesh, axis)
    assert n % (n_shards * chunk) == 0, (n, n_shards, chunk)
    if dp_axis is not None and b % dist.mesh_axis_size(mesh, dp_axis) != 0:
        dp_axis = None
    spec = dist.P(dp_axis, None, axis, None)
    fn = dist.shard_map(
        lambda ql, kl, vl: taylor_cp_local(ql, kl, vl, cfg, mesh, axis, chunk),
        mesh, in_specs=(spec, spec, spec), out_specs=spec,
    )
    return fn(q, k, v)
