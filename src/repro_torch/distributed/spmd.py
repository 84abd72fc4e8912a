"""The layout hooks of the model's one forward on a mesh.

``models/lm.py``, ``models/blocks.py`` and ``train/step.py`` call the
hooks below at the points where the JAX package constrains a layout.
Outside a ``region`` every hook is the identity (or the plain call), so
every unsharded path runs as it did.  Inside one, each rank holds its
local block of each parameter (``param_specs``) and its rows of the batch
(``local_batch``: batch over "dp"), and the hooks reach the layout that
the reference names at each site with the differentiable collectives of
``distributed/collectives.py``, where GSPMD would insert them:

  * the residual stream ``x`` is ``("dp", "sp", None)``: batch over "data",
    sequence over "model" where they divide (``models/lm.py:163, 217`` of
    the reference): ``to_stream`` after the embedding;
  * ``site(kind="attn")`` gathers the sequence, runs the block's
    projections, the backend's ``apply`` (the CUDA kernels on a card) and
    the output projection on its local heads — q over
    ``("dp", "tp", None, None)`` (``attention.py:79``) — and
    reduce-scatters the partial sums back to the sequence blocks
    (``attention.py:96``).  Heads split only where both the query and the
    kv head counts divide by the "tp" axis; otherwise every rank of the
    axis runs all heads (the reference's divisibility fallback replicates
    the kv heads; the port replicates the query heads with them, which
    gives the same numbers);
  * ``site(kind="cross")`` is ``"attn"`` with k and v from the source
    ``kv_src`` [b_loc, m, d] (``attention.py:122-126``): q from the gathered
    stream, the source whole along its own sequence on this rank's "dp"
    rows, the same head split, no RoPE on k/v and ``causal=False``.  Where
    the heads split, each rank projects the source with its own heads'
    ``wk``/``wv`` only, so the source's cotangent is a partial sum over
    "tp": the site sums it over "tp" in the backward (as ``use_param``'s
    ``split`` does for a parameter), and the encoder's and ``vision_proj``'s
    gradients come out whole;
  * the encoder (``sequence``) is a residual stream of its own length
    (``lm.py:220-232`` of the reference): its "sp" resolves against that
    length, its blocks run the same sites non-causally, and
    ``from_stream`` gathers its output whole along the sequence for the
    cross sites;
  * ``site(kind="mlp")`` splits ``d_ff`` over "tp" where it divides, the
    same way (under cp too: gathering the sequence moves fewer bytes than
    gathering its weights); its output bias is added by "tp" rank 0 only,
    so that the reduction adds it once;
  * under ``attn_sharding="cp"`` causal self-attention keeps its sequence
    block (``attention.py:78``): the Taylor backend exchanges one moment
    state (``core/context_parallel.py``) and a mamba block one SSD state
    (``ssm.py:185-200``); no kernel runs there.  The non-causal encoder and
    the cross sites take the "tp" way instead: the reference's non-causal
    Taylor ``apply`` exchanges no state (``backends/taylor.py:172-174``),
    and the gathered sequence gives the same numbers;
  * ``site(kind="mamba")`` under "tp" runs the block whole on every rank of
    the axis (its in_proj splits z|x|B|C|dt along one dim, which the port
    does not cut);
  * the logits are ``("dp", "sp", None)`` (``lm.py:249``: "sp" takes the
    "model" axis before "tp" can), and ``mean_nll`` sums the loss over the
    ranks.

A parameter is gathered for compute by ``use_param``: whole along every
axis of its spec except the ones a site keeps split ("tp" heads), and its
gradient is summed over the axes on which that site's compute saw
different data and sliced back to the block.  So gradients come out in
the parameters' own layout and equal the single-device step's.  The
region finds a leaf's spec by the leaf itself (the tensors the forward
reads are those that the region was given).

The scans inside the Taylor and SSD backends run on local blocks that are
already batch-split, which is all the reference's constraints at
``core/taylor.py:85, 366-368`` and ``core/taylor_vjp.py:123-125`` ask.

Serving (``serve_layout``): the cache-carrying paths (``lm_prefill``,
``lm_decode_step``, ``lm_prefill_chunk``, ``lm_verify_chunk``) run the
same blocks through the same hooks, each ``site`` carrying this rank's
block of its layer's decode state (``site(..., state=)``), as
``distributed.sharding.slot_cache_specs`` names it.  The residual stream
stays whole (no "sp"); the slotted batch splits over "dp" (``rows`` /
``all_rows`` move per-slot vectors between the whole and the rank's
rows), a request's batch runs whole on every "data" rank.  Attention
(and a cross block's read state, ``site("cross", ..., state=)``, which
the prefill builds from the source and decode only reads) splits over
"model" by ``attn_mode``: its heads where the kv heads divide ("heads"), else the value columns d_v where the spec puts "tp" on them
("dv", MQA: each rank computes its d_v columns of the numerator over the
whole denominator, and the output projection runs row-split with a sum),
else whole; a mamba block runs whole.  A state leaf that the spec splits
but the compute runs whole (the key moments under "dv", the SSD heads and
conv channels of a mamba block) is gathered before the step and cut back
to its block after it.

MoE blocks (``models/moe.py::moe_apply``): the shared experts run as a
block's MLP (``site("mlp")``, their ``d_ff`` over "tp"); the routed
experts take one of two hooks.  ``moe_rows`` is the reference's
``ep_a2a`` shard_map (``moe.py:176-283`` of the reference): the sequence
is gathered to the rows of this rank's "data" shard (input ``P(dp, None,
None)``), so every rank of "model" routes the same tokens; the router is
gathered whole, the experts keep their blocks over "ep" (padded and cut
there where the expert count does not divide) and are gathered over
"fsdp"; the output is cut back to the stream's block.  Each expert then
receives ep copies of each routed token, one from each rank of "model":
the reference's transpose (``check_vma=False``) divides the cotangent of
the output by ep and sums the input cotangents over ep, which leaves each
expert's gradient counted once; here the experts' gradient is scaled by
1/ep (``collectives.scale_grad``), and the inputs' are already counted
once.  ``moe_whole`` runs the dense and capacity paths (and ``ep_a2a``
over an ep axis of one rank) on the whole batch on every rank, as GSPMD
gives the single-device numbers: global capacity and positions, the aux
loss from global means.

Inside a region every hook names its collectives (``collectives.named``):
``site`` by its kind, the others by their own names, under the layer that
the model's forwards name with ``layer`` — so a record of
``collectives.recording`` says ``"layer3/attn"`` or ``"layer3/attn/bwd"``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import api as dist
from repro_torch.distributed import collectives as col
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor


def _named(name: str):
    """Inside a region, the decorated hook's collectives have ``name`` as the
    last part of their site (``collectives.named``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _REGION.get() is None:
                return fn(*args, **kwargs)
            with col.named(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def layer(name: str):
    """Inside a region, names the collectives of one layer (``"layer3"``): the
    model's forwards wrap each block in it."""
    return col.named(name) if _REGION.get() is not None else contextlib.nullcontext()


class Layout(NamedTuple):
    """How one batch lies on the mesh."""

    mesh: Any
    rules: Any
    dp: Any            # batch axis (or tuple), None when the batch does not divide
    sp: Optional[str]  # residual-stream sequence axis, None when n does not divide
    tp: Optional[str]  # the tensor-parallel axis ("model"), None when off
    n: int             # whole sequence length
    b: int             # whole batch

    @property
    def dp_names(self) -> Tuple[str, ...]:
        return dist.entry_names(self.dp)

    def size(self, axis) -> int:
        return 1 if axis is None else dist.mesh_axis_size(self.mesh, axis)


def layout_for(mesh, rules, b: int, n: int, d: int) -> Layout:
    """The residual stream's layout, ``("dp", "sp", None)`` resolved for
    ``[b, n, d]``."""
    dp, sp, _ = dist.resolve_axes(("dp", "sp", None), (b, n, d), mesh, rules)
    tp = rules.get("tp")
    if tp is not None and dist.mesh_axis_size(mesh, tp) == 1:
        tp = None
    return Layout(mesh, rules, dp, sp, tp, n, b)


def serve_layout(mesh, rules, b: int, slotted: bool) -> Layout:
    """A serve engine's layout for a batch of ``b`` rows: the slotted batch
    (``slotted``) over "dp" where it divides, a request's batch whole on
    every rank of "data" (a batch-1 admission does not divide: every rank
    runs it, and the slot's owner keeps the state); heads over "tp"; the
    residual stream whole."""
    dp = dist.resolve_axes(("dp",), (b,), mesh, rules)[0] if slotted else None
    tp = rules.get("tp")
    if tp is not None and dist.mesh_axis_size(mesh, tp) == 1:
        tp = None
    return Layout(mesh, rules, dp, None, tp, 0, b)


def rows(x: Tensor) -> Tensor:
    """This rank's rows of a whole per-row tensor (a slot vector, a window)
    where the region's batch splits over "dp"; else ``x``."""
    r = _REGION.get()
    if r is None or not r.lay.dp:
        return x
    return col.slice_values(x, 0, r.lay.mesh, r.lay.dp)


@_named("all_rows")
def all_rows(x: Tensor) -> Tensor:
    """The whole of a per-row tensor from this rank's rows (a collective
    where the batch splits over "dp"); else ``x``."""
    r = _REGION.get()
    if r is None or not r.lay.dp:
        return x
    return col.gather_values(x, 0, r.lay.mesh, r.lay.dp)


def attn_mode(cfg, size: int) -> str:
    """How a serve engine splits a layer's attention over a "model" axis of
    ``size``: its heads where the kv heads divide ("heads"); else, where the
    value head dim divides, the d_v columns that ``cache_pspec``'s
    last-dim fallback gives the value leaves ("dv"); else not at all."""
    if size <= 1:
        return "whole"
    if cfg.n_heads % size == 0 and cfg.n_kv_heads % size == 0:
        return "heads"
    return "dv" if cfg.resolved_head_dim % size == 0 else "whole"


class _Region(NamedTuple):
    lay: Layout
    specs: Dict[int, Any]  # id of a parameter leaf -> its spec
    leaves: list           # the leaves themselves, kept alive with their ids


_REGION: contextvars.ContextVar[Optional[_Region]] = contextvars.ContextVar(
    "repro_torch_spmd_region", default=None
)


@contextlib.contextmanager
def region(lay: Layout, params, specs):
    """Within it, the model's forward runs on this rank's blocks:
    ``params`` (this rank's blocks, the very tensors the forward reads)
    have ``specs``, the batch lies as ``lay`` says.  It also enters the
    rules (``api.sharding_rules``) that the backends read."""
    leaves = tree_leaves(params)
    ids = {id(x): s for x, s in zip(leaves, tree_leaves(specs))}
    with dist.sharding_rules(lay.mesh, lay.rules):
        token = _REGION.set(_Region(lay, ids, leaves))
        try:
            yield lay
        finally:
            _REGION.reset(token)


def in_region() -> bool:
    return _REGION.get() is not None


def axis_size(logical: str) -> int:
    """The size of the region's physical axis for ``logical`` (1 outside a
    region or where the rules leave it off)."""
    r = _REGION.get()
    return 1 if r is None else r.lay.size(r.lay.rules.get(logical))


def local_batch(batch: Dict[str, Tensor], lay: Layout) -> Dict[str, Tensor]:
    """This rank's rows of a whole batch (the same on every rank)."""
    return {k: col.slice_values(v, 0, lay.mesh, lay.dp) if lay.dp else v
            for k, v in batch.items()}


def use_param(p: Tensor, spec, lay: Layout, keep=(), split=()) -> Tensor:
    """A parameter block made whole for compute along every axis of its
    spec but those in ``keep``; its gradient is summed over the axes in
    ``split`` (where this site's compute sees different data on each rank)
    and sliced back to the block."""
    own = set()
    for dim, entry in enumerate(spec):
        own.update(dist.entry_names(entry))
        if entry is not None and entry not in keep:
            p = col.all_gather(p, dim, lay.mesh, entry,
                               grad="sum" if entry in split else "slice")
    for name in split:
        if name not in own:
            p = col.sum_grad(p, lay.mesh, name)
    return p


def _use_tree(r: _Region, tree, keep=(), split=()):
    if isinstance(tree, dict):
        return {k: _use_tree(r, v, keep, split) for k, v in tree.items()}
    if id(tree) not in r.specs:
        raise KeyError("a parameter read inside spmd.region that is not one of its leaves")
    return use_param(tree, r.specs[id(tree)], r.lay, keep, split)


def _split_axes(lay: Layout, seq_split: bool) -> Tuple[str, ...]:
    """Axes on which a site's compute sees different data: the batch axes,
    and the sequence axis where the site runs on sequence blocks."""
    return lay.dp_names + ((lay.sp,) if seq_split and lay.sp else ())


@_named("on_rows")
def on_rows(tree):
    """Parameters read by compute on this rank's batch rows and the whole
    sequence (the embedding)."""
    r = _REGION.get()
    return tree if r is None else _use_tree(r, tree, split=r.lay.dp_names)


@_named("on_stream")
def on_stream(tree):
    """Parameters read by compute on the residual stream's blocks (norms,
    the unembedding)."""
    r = _REGION.get()
    return tree if r is None else _use_tree(r, tree, split=_split_axes(r.lay, True))


@_named("to_stream")
def to_stream(x: Tensor) -> Tensor:
    """The embedding's output ``[b_loc, n, d]`` -> the residual stream's
    blocks."""
    r = _REGION.get()
    if r is None or not r.lay.sp:
        return x
    return col.scatter(x, 1, r.lay.mesh, r.lay.sp)


@contextlib.contextmanager
def sequence(n: int):
    """Within it, the residual stream is a sequence of ``n`` positions of its
    own (the encoder's): "sp" resolves against ``n``, and the stream stays
    whole where ``n`` does not divide.  A serving layout (its stream whole,
    ``n`` 0) stays as it is."""
    r = _REGION.get()
    if r is None or not r.lay.n:
        yield
        return
    lay = r.lay
    sp = dist.resolve_axes(("dp", "sp", None), (lay.b, n, 1), lay.mesh, lay.rules)[1]
    token = _REGION.set(r._replace(lay=lay._replace(sp=sp, n=n)))
    try:
        yield
    finally:
        _REGION.reset(token)


@_named("from_stream")
def from_stream(x: Tensor) -> Tensor:
    """The stream's blocks -> its whole sequence on this rank's rows (the
    encoder's output, which every cross site reads whole).  Each rank's
    cotangent is then the whole one (a cross site sums its partial sums
    over "tp"), so the backward keeps this rank's block of it."""
    r = _REGION.get()
    if r is None or not r.lay.sp:
        return x
    return col.all_gather(x, 1, r.lay.mesh, r.lay.sp, grad="slice")


def stream_block(x: Tensor) -> Tensor:
    """This rank's sequence block of a per-position tensor of its rows
    (the labels), outside autograd."""
    r = _REGION.get()
    if r is None or not r.lay.sp:
        return x
    return col.slice_values(x, 1, r.lay.mesh, r.lay.sp)


@_named("mean_nll")
def mean_nll(nll: Tensor) -> Tensor:
    """The mean over the whole batch of the per-token losses, from this
    rank's block of them."""
    r = _REGION.get()
    if r is None:
        return nll.mean()
    total = nll.sum()
    for name in _split_axes(r.lay, True):
        total = col.all_reduce(total, r.lay.mesh, name)
    return total / (r.lay.b * r.lay.n)


def _enter(h: Tensor, lay: Layout, tp_split: bool) -> Tensor:
    """Residual-stream blocks -> the whole sequence for a site's compute."""
    if lay.sp:
        return col.all_gather(h, 1, lay.mesh, lay.sp, grad="sum" if tp_split else "slice")
    return col.sum_grad(h, lay.mesh, lay.tp) if tp_split else h


def _exit(y: Tensor, lay: Layout, tp_split: bool) -> Tensor:
    """A site's output (partial sums over "tp" where it split) -> the
    residual stream's blocks."""
    if tp_split:
        if lay.sp:
            return col.reduce_scatter(y, 1, lay.mesh, lay.sp)
        return col.all_reduce(y, lay.mesh, lay.tp)
    return col.scatter(y, 1, lay.mesh, lay.sp) if lay.sp else y


def _tp_axis(kind: str, cfg, lay: Layout):
    """The axis a site splits over "tp", or None where it runs whole."""
    if lay.tp is None:
        return None
    size = lay.size(lay.tp)
    if (kind in ("attn", "cross") and cfg.n_heads % size == 0
            and cfg.n_kv_heads % size == 0):
        return lay.tp
    if kind == "mlp" and cfg.d_ff % size == 0:
        return lay.tp
    return None


_NO_STATE = object()


@functools.lru_cache(maxsize=None)
def _model_specs(kind: str, cfg, axis, sizes: Tuple[Tuple[str, int], ...]):
    """The "model" entries of one layer's decode-state spec (its backend's
    ``cache_pspec`` resolved as ``slot_cache_specs`` resolves it)."""
    from repro_torch.backends import state_backend  # noqa: PLC0415 (cycle)
    from repro_torch.distributed.sharding import _resolve_logical_spec  # noqa: PLC0415
    from repro_torch.tree import tree_map  # noqa: PLC0415

    class Sizes:
        axis_names = tuple(n for n, _ in sizes)
        shape = dict(sizes)

    backend = state_backend(kind, cfg)
    shapes = backend.init_cache(cfg, 1, 1, torch.device("meta"), torch.float32)
    return tree_map(lambda p, x: _resolve_logical_spec(p, x.shape, {"tp": axis}, Sizes()),
                    backend.cache_pspec(cfg), shapes)


def _reblock(state, held, lay: Layout, keep, gather: bool):
    """Leaves of a layer's state that ``held`` splits over "tp" and the
    compute runs whole (all but the fields in ``keep``): gathered whole
    (``gather``) or cut back to this rank's block."""
    if state is None:
        return None
    out = []
    for name, x, spec in zip(state._fields, state, held):
        if x is not None and name not in keep:
            for dim, entry in enumerate(spec):
                if entry is not None:
                    x = (col.gather_values(x, dim, lay.mesh, entry) if gather
                         else col.slice_values(x, dim, lay.mesh, entry).contiguous())
        out.append(x)
    return type(state)(*out)


def site(kind: str, fn, params, h: Tensor, cfg, positions: Optional[Tensor] = None,
         state=_NO_STATE, causal: bool = True):
    """``fn(params, h, cfg, positions)``: a block's ``"attn"``, ``"cross"``,
    ``"mlp"`` or ``"mamba"`` compute on the normed residual ``h``.  In a
    region ``h`` is the stream's blocks and so is the output; ``positions``
    are the whole sequence's, and for ``"cross"`` the source ``kv_src``
    [b, m, d] (this rank's rows, its whole sequence; None where only the
    state is read).  With ``state`` (a layer's decode cache or cross read
    state, or None for a prefill) ``fn`` takes it as a fifth argument and
    returns ``(y, new state)``, the state being this rank's block of it (see
    the module docstring for how serving splits each site).  ``causal`` is
    False for the encoder's self-attention, which never takes the
    context-parallel way."""
    carry = state is not _NO_STATE
    r = _REGION.get()
    if r is None:
        return fn(params, h, cfg, positions, state) if carry else fn(params, h, cfg, positions)
    with col.named(kind):
        return _site(r, kind, fn, params, h, cfg, positions, state, causal)


def _site(r: _Region, kind: str, fn, params, h: Tensor, cfg, positions, state, causal: bool):
    """``site`` inside a region."""
    carry = state is not _NO_STATE
    lay = r.lay
    if (kind in ("attn", "mamba") and causal and cfg.attn_sharding == "cp"
            and lay.sp is not None and (lay.n // lay.size(lay.sp)) % cfg.attn_chunk == 0):
        # context parallel: the sequence blocks stay, one state is exchanged
        w = _use_tree(r, params, split=_split_axes(lay, True))
        if positions is not None:
            positions = col.slice_values(positions, 0, lay.mesh, lay.sp)
        return fn(w, h, cfg, positions)
    if cfg.attn_sharding == "cp":
        cfg = cfg.replace(attn_sharding="tp")
    tp = _tp_axis(kind, cfg, lay)
    mode = "heads" if tp else "whole"
    if carry and kind in ("attn", "cross") and not tp and lay.tp:
        mode = attn_mode(cfg, lay.size(lay.tp))
    split = tp or (lay.tp if mode == "dv" else None)
    hf = _enter(h, lay, split is not None)
    if kind == "cross" and tp and positions is not None:
        # every rank's heads read the whole source: sum its cotangent's shares
        positions = col.sum_grad(positions, lay.mesh, tp)
    w = _use_tree(r, params, keep=(split,) if split else (), split=_split_axes(lay, False))
    held, keep = None, ()
    if carry and kind != "mlp" and lay.tp and mode != "heads":
        sizes = tuple((n, dist.mesh_axis_size(lay.mesh, n)) for n in dist.entry_names(lay.tp))
        from repro_torch.backends import state_backend  # noqa: PLC0415 (cycle)

        held = _model_specs(kind, cfg, lay.tp, sizes)
        keep = state_backend(kind, cfg).value_leaves if mode == "dv" else ()
        state = _reblock(state, held, lay, keep, gather=True)
    if tp and kind in ("attn", "cross"):
        size = lay.size(tp)
        cfg = cfg.replace(n_heads=cfg.n_heads // size, n_kv_heads=cfg.n_kv_heads // size,
                          head_dim=cfg.resolved_head_dim)
    if tp and "b_down" in w:  # added by one rank, so that the reduction adds it once
        first = float(col.axis_rank(lay.mesh, tp) == 0)
        w = dict(w, b_down=col.sum_grad(w["b_down"], lay.mesh, tp) * first)
    if not carry:
        return _exit(fn(w, hf, cfg, positions), lay, split is not None)
    y, state = fn(w, hf, cfg, positions, state)
    if held is not None:
        state = _reblock(state, held, lay, keep, gather=False)
    return _exit(y, lay, split is not None), state


@_named("moe_rows")
def moe_rows(fn, params, h: Tensor, pad):
    """A MoE block's routed experts under expert parallelism, on the normed
    residual's block ``h``: ``fn(params, x, mesh, dp, ep)`` runs on this
    rank's "data" shard ``x`` [b_loc, n, d] (every rank of "model" the
    same rows), the router whole and this rank's experts over "ep"
    (``pad`` gives an expert leaf whole over "ep" its padded rows before it
    is cut), and returns (y [b_loc, n, d], aux).  Returns the stream's
    block of y, and aux."""
    r = _REGION.get()
    lay = r.lay
    ep = lay.rules.get("ep")
    size = lay.size(ep)
    x = col.all_gather(h, 1, lay.mesh, lay.sp, grad="slice") if lay.sp else h
    experts = {}
    for name, leaf in params["experts"].items():
        spec = r.specs[id(leaf)]
        w = use_param(leaf, spec, lay, keep=(ep,), split=lay.dp_names)
        if not (len(spec) and spec[0] == ep):
            w = col.scatter(pad({name: w})[name], 0, lay.mesh, ep)
        experts[name] = col.scale_grad(w, 1.0 / size)
    w = {"router": _use_tree(r, params["router"], split=lay.dp_names), "experts": experts}
    y, aux = fn(w, x, lay.mesh, lay.dp, ep)
    return (col.scatter(y, 1, lay.mesh, lay.sp) if lay.sp else y), aux


@_named("moe_whole")
def moe_whole(fn, params, h: Tensor):
    """A MoE block's routed experts on the whole batch: the stream's blocks
    gathered into ``x`` [b, n, d] on every rank, ``fn(params, x)`` with every
    parameter whole (-> (y, aux), y of x's size), y cut back to this rank's
    block.  Every rank computes the same function, so every gradient comes
    out whole and counted once."""
    r = _REGION.get()
    lay = r.lay
    x = h
    if lay.sp:
        x = col.all_gather(x, 1, lay.mesh, lay.sp, grad="slice")
    if lay.dp:
        x = col.all_gather(x, 0, lay.mesh, lay.dp, grad="slice")
    y, aux = fn(_use_tree(r, params), x)
    y = y.reshape(x.shape)
    if lay.dp:
        y = col.scatter(y, 0, lay.mesh, lay.dp)
    if lay.sp:
        y = col.scatter(y, 1, lay.mesh, lay.sp)
    return y, aux
