"""Checkpoints in the JAX trainer's layout: read into the port's TrainState.

The JAX trainer (``repro.train.run_training`` over ``repro.checkpoint``)
writes ``<dir>/step_N/host_0.npz``, keyed by ``jax.tree_util.keystr`` paths
of its ``TrainState`` (``.params['blocks']['group']['r0']...``,
``.opt_state.m[...]``, ``.opt_state.v[...].row``), bf16 arrays as uint16
views beside a dtype manifest: the format of the port's own store
(``checkpoint.store``), whose paths (``repro_torch.tree``) are the same.
Only the layout differs: the JAX tree stacks block leaves over
``[n_groups, run_len]`` where the port keeps one dict per layer.

So the params, and the optimizer moments that have their structure
(AdamW's m and v, SGD's m), are restacked through the weight bridge
(``models.convert.to_jax_layout``) to read or write, and unstacked
(``params_from_jax``) after reading; Adafactor's state is in the stacked
layout already (``optim.adafactor``) and is read as it is, its ``(1,)``
placeholders included.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint.store import restore_checkpoint
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax, to_jax_layout
from repro_torch.optim.optimizers import AdafactorState, AdamState, SgdState


def _map_param_trees(opt_state, fn):
    """``fn`` over the optimizer state's param-shaped trees."""
    if isinstance(opt_state, AdamState):
        return opt_state._replace(m=fn(opt_state.m), v=fn(opt_state.v))
    if isinstance(opt_state, SgdState):
        return opt_state._replace(m=fn(opt_state.m))
    if isinstance(opt_state, AdafactorState):
        return opt_state
    raise TypeError(f"unknown optimizer state {type(opt_state).__name__}")


def to_jax_layout_state(state, cfg: ModelConfig):
    """The port's ``TrainState`` in the JAX trainer's layout (block leaves
    stacked with ``torch.stack``); ``store.save_checkpoint`` of it writes
    the file the JAX trainer would."""
    stack = lambda rows: torch.stack([torch.stack(row) for row in rows])
    lay = lambda tree: to_jax_layout(tree, cfg, stack)
    return state._replace(params=lay(state.params),
                          opt_state=_map_param_trees(state.opt_state, lay))


def _from_jax_layout_state(state, cfg: ModelConfig):
    """Inverse of ``to_jax_layout_state``: one dict per layer again (copies
    on the state's device)."""
    unlay = lambda tree: params_from_jax(tree, cfg, device=state.step.device)
    return state._replace(params=unlay(state.params),
                          opt_state=_map_param_trees(state.opt_state, unlay))


def restore_jax_checkpoint(directory: str, template, cfg: ModelConfig,
                           step: Optional[int] = None, placements=None):
    """Read a checkpoint the JAX trainer wrote into the port's ``TrainState``.

    Args:
      directory: the JAX run's checkpoint directory (``step_N/host_0.npz``).
      template: a port ``TrainState`` of the same model and optimizer
        (e.g. ``train_state_init``'s); each leaf takes its template leaf's
        dtype and device.
      cfg: the model's config (the stacking).
      step: the step to read (default: the newest committed one).
      placements: a ``distributed.sharding.Placements`` of the state on a
        mesh; ``template``'s leaves are then this rank's blocks, and so
        are the leaves returned (the elastic reshard path of
        ``store.restore_checkpoint``).

    Returns:
      The port's ``TrainState``.  Raises when a key or shape of the file
      differs from the template's.
    """
    if placements is None:
        jtemplate = to_jax_layout_state(template, cfg)
        return _from_jax_layout_state(restore_checkpoint(directory, jtemplate, step=step), cfg)
    from repro_torch.distributed.sharding import distribute_tree, whole_template  # noqa: PLC0415

    whole = restore_jax_checkpoint(directory, whole_template(template, placements), cfg, step)
    blocks = distribute_tree(whole, placements)
    return _map_leaves(lambda b, t: b.to(t.device), blocks, template)


def _map_leaves(fn, tree, template):
    from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: PLC0415

    return tree_unflatten(template, [fn(a, b) for a, b in zip(tree_leaves(tree),
                                                                tree_leaves(template))])
