"""mfu.zamba2: a Zamba2 training step's share of the chip's bf16 peak in the
traced window: the frozen model FLOPs of a step (``counts/zamba2.py``) times
the steps finished, over the window's seconds on the host clock times
989 TFLOP/s."""

from portbench.counts import peaks, zamba2


def read(ctx):
    layer = ctx["layer"]
    if not layer.get("steps"):
        return None
    flops = zamba2.train_step_flops(ctx["config"], layer["batch"], layer["seq"])
    return 100.0 * flops * layer["steps"] / (layer["window_s"] * peaks.BF16_FLOPS)
