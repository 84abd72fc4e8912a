"""Training: loss, step function, fault-tolerant loop."""

from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import (
    TrainState,
    cross_entropy,
    loss_and_grads,
    make_loss_fn,
    make_train_step,
    train_state_init,
)

__all__ = [
    "TrainLoopConfig",
    "TrainState",
    "cross_entropy",
    "loss_and_grads",
    "make_loss_fn",
    "make_train_step",
    "run_training",
    "train_state_init",
]
