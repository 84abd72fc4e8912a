"""optimizer_ms.train: the device time a step of the optimizer, the span
``repro_torch.optimizer`` around the optimizer's update and
``apply_updates`` (global-norm clip, AdamW, the successor parameters);
None unless the window holds one call of it a step."""

from portbench.program_spans import PREFIX, device_ms_a_step

SPANS = ("optimizer",)
OPS = tuple(PREFIX + s for s in SPANS)


def read(ctx):
    return device_ms_a_step(ctx, SPANS, one_a_step=True)
