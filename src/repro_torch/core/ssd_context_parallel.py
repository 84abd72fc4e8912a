"""Context parallelism for SSD (Mamba2): the decay-weighted analogue of
``core/context_parallel.py``.

SSD states are *decayed* sums, so merging sequence shards needs one more
ingredient than the Taylor moments: shard i's incoming state is

    H_i = Σ_{j<i} exp(Σ_{j<l<i} total_l) · L_j

where L_j is shard j's locally accumulated state and total_j its total
log decay.  One all-gather of (L_j [b,H,P,N], total_j [b,H]), packed in one
buffer, replaces any O(n) ring exchange; outputs are corrected in closed
form with the local cumulative decays (y_t += C_t · exp(cum_t) H_i).  The
weights of shards j ≥ i are masked to -inf before ``exp``, as the port's
``_ssd_chunked`` masks its decay exponent, so gradients stay finite.
"""

from __future__ import annotations

import torch

from repro_torch.core.context_parallel import exchange
from repro_torch.distributed import api as dist
from repro_torch.distributed import collectives as col
from repro_torch.models.ssm import _ssd_chunked

Tensor = torch.Tensor


def ssd_cp_local(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, mesh, axis: str,
                 chunk: int) -> Tensor:
    """One rank's SSD over its sequence block: x ``[b, n_loc, H, P]``, dt
    ``[b, n_loc, H]`` (post-softplus), A ``[H]``, B/C ``[b, n_loc, G, N]``.
    Returns ``y [b, n_loc, H, P]`` in float32."""
    b, n_loc, H, Pd = x.shape
    y_local, L = _ssd_chunked(x, dt, A, B, C, chunk, return_state=True)
    la = dt.float() * A.float()[None, None, :]
    total = la.sum(dim=1)  # [b, H]
    gathered = exchange([L.reshape(b, H, -1), total[..., None]], mesh, axis)
    Ls = gathered[..., :-1].reshape((-1,) + L.shape)  # [S, b, H, P, N]
    totals = gathered[..., -1]  # [S, b, H]
    n_shards = gathered.shape[0]
    idx = col.axis_rank(mesh, axis)
    tcum = totals.cumsum(dim=0)  # inclusive prefix of log decays
    prev = tcum[idx - 1] if idx > 0 else torch.zeros_like(tcum[0])
    earlier = (torch.arange(n_shards, device=x.device) < idx)[:, None, None]
    # w_j = exp(Σ_{l=j+1..i-1} total_l) for j < i, else 0
    w = torch.exp((prev[None] - tcum).masked_fill(~earlier, float("-inf")))
    H_in = torch.einsum("sbh,sbhpn->bhpn", w, Ls)
    rep = H // B.shape[2]
    Ch = C.repeat_interleave(rep, dim=2).float()
    cum = la.cumsum(dim=1)
    y_corr = torch.einsum("bihn,bhpn,bih->bihp", Ch, H_in, torch.exp(cum))
    return y_local + y_corr


def ssd_context_parallel(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, mesh,
                         axis: str, chunk: int = 128, dp_axis=None) -> Tensor:
    """Whole tensors (the same on every rank), the sequence sharded over
    ``axis`` and the batch over ``dp_axis`` where it divides.  Returns the
    whole ``y [b, n, H, P]`` on every rank."""
    b, n = x.shape[:2]
    n_shards = dist.mesh_axis_size(mesh, axis)
    assert n % (n_shards * chunk) == 0, (n, n_shards, chunk)
    if dp_axis is not None and b % dist.mesh_axis_size(mesh, dp_axis) != 0:
        dp_axis = None
    spec4 = dist.P(dp_axis, axis, None, None)
    spec3 = dist.P(dp_axis, axis, None)
    fn = dist.shard_map(
        lambda xl, dtl, Al, Bl, Cl: ssd_cp_local(xl, dtl, Al, Bl, Cl, mesh, axis, chunk),
        mesh, in_specs=(spec4, spec3, dist.P(None), spec4, spec4), out_specs=spec4,
    )
    return fn(x, dt, A, B, C)
