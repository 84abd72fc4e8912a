"""mfu.train: the training step's share of the chip's bf16 peak in the
traced window: the frozen model FLOPs of a step (``counts/model.py``) times
the steps finished, over the window's seconds on the host clock times
989 TFLOP/s."""

from portbench.counts import model, peaks


def read(ctx):
    layer = ctx["layer"]
    if not layer.get("steps"):
        return None
    flops = model.train_step_flops(ctx["config"], layer["batch"], layer["seq"])
    return 100.0 * flops * layer["steps"] / (layer["window_s"] * peaks.BF16_FLOPS)
