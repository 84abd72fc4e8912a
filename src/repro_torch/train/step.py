"""Loss + train step (functional over the param tree), on one device or on
a mesh (``make_sharded_train_step``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch import spans
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding, spmd
from repro_torch.models import lm_apply, lm_init
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


class TrainState(NamedTuple):
    step: Tensor  # int32 0-d
    params: Any
    opt_state: Any


def train_state_init(
    gen: torch.Generator, cfg: ModelConfig, optimizer: Optimizer, device=None
) -> TrainState:
    """Random params (``lm_init``) and a fresh optimizer state on ``device``
    (``None``: the CUDA card; raises without one)."""
    device = resolve_device(device)
    params = lm_init(gen, cfg, device=device)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        opt_state=optimizer.init(params),
    )


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token NLL.  logits fp32 [b, n, v]; labels int [b, n]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    labels = spmd.stream_block(labels)  # a mesh's logits are the rank's sequence block
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return spmd.mean_nll(logz - gold)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01):
    """loss_fn(params, batch) -> (nll + aux_weight·aux, metrics)."""

    def loss_fn(params, batch: Dict[str, Tensor]):
        logits, aux = lm_apply(params, batch, cfg)
        with spans.span("loss"):
            nll = spans.backward_begin(cross_entropy(logits, batch["labels"]), "head.bwd")
        loss = nll + aux_weight * aux
        return loss, {"loss": nll, "aux_loss": aux}

    return loss_fn


def loss_and_grads(loss_fn, params, batch: Dict[str, Tensor]):
    """(loss, metrics, grads): ``torch.autograd.grad`` over the param leaves.

    The leaves are detached views that require grad, so ``params`` itself is
    left as it is.  The forward and backward are the spans ``train.forward``
    and ``train.backward``, each counting the allocator's calls on the
    params' device (``spans.span``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    dev = leaves[0].device
    with spans.span("train.forward", dev):
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
    with spans.span("train.backward", dev):
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, aux_weight: float = 0.01,
                    donate: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``donate``: the step writes the new params and optimizer state into the
    tensors of the state it is given (``optimizer.update_in_place``), as a
    JAX step jitted with ``donate_argnums`` reuses its state's buffers; the
    state passed in is then spent.  A state's params and moments are then
    held once, not twice, across the optimizer.

    Its spans (``repro_torch.spans``): ``train.first_step`` (set-up) around
    the process's first step; ``train.forward``, ``train.backward`` and
    ``optimizer``, each counting the allocator's calls on the step's
    device."""
    loss_fn = make_loss_fn(cfg, aux_weight)
    if donate and optimizer.update_in_place is None:
        raise ValueError("a donated step needs an optimizer with update_in_place (adamw)")

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        with spans.once("train.first_step"):
            loss, metrics, grads = loss_and_grads(loss_fn, state.params, batch)
            with torch.no_grad(), spans.span("optimizer", loss.device):
                if donate:
                    params = state.params
                    opt_state = optimizer.update_in_place(grads, state.opt_state, params)
                else:
                    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
                    params = apply_updates(state.params, updates)
        metrics = dict(metrics, total_loss=loss)
        return TrainState(state.step + 1, params, opt_state), metrics

    return train_step


def make_sharded_train_step(cfg: ModelConfig, optimizer: Optimizer, placements, rules,
                            aux_weight: float = 0.01):
    """train_step(state, batch) -> (state, metrics) on a mesh.

    ``placements`` (a ``distributed.sharding.Placements`` of the
    ``TrainState``) gives each leaf's block; ``batch`` is whole and the same
    on every rank (each takes its rows).  The loss is ``make_loss_fn``'s,
    run inside ``distributed.spmd.region``; the transposes of the region's
    collectives deliver each gradient summed over the ranks and in its
    parameter's own layout, and the optimizer sums each leaf over its
    blocks where it reduces one (the clip norm, Adafactor's statistics), so
    the update equals the single-device step's.  Metrics come back the same
    on every rank.  Its spans are ``make_train_step``'s."""
    loss_fn = make_loss_fn(cfg, aux_weight)
    mesh, pspecs = placements.mesh, placements.specs.params
    param_placements = sharding.Placements(mesh, pspecs)

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        b, n = batch["tokens"].shape
        lay = spmd.layout_for(mesh, rules, b, n, cfg.d_model)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        dev = leaves[0].device
        with spans.once("train.first_step"):
            with spans.span("train.forward", dev), spmd.region(lay, params, pspecs):
                loss, metrics = loss_fn(params, spmd.local_batch(batch, lay))
            with spans.span("train.backward", dev):
                grads = tree_unflatten(state.params, list(torch.autograd.grad(loss, leaves)))
            with torch.no_grad(), spans.span("optimizer", dev), col.named("optimizer"):
                updates, opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                      placements=param_placements)
                params = apply_updates(state.params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = loss.detach()
        return TrainState(state.step + 1, params, opt_state), metrics

    return train_step
