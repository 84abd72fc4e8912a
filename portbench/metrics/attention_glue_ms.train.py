"""attention_glue_ms.train: the device time a step of the attention
backend's glue around the Taylor ops, forward and backward: q/k LayerNorm,
layouts, padding, slicing and casts (spans ``repro_torch.attention.prep``
and ``repro_torch.attention.post``; the LayerNorm's backward is not in
them)."""

from portbench.program_spans import PREFIX, device_ms_a_step

SPANS = ("attention.prep", "attention.post")
OPS = tuple(PREFIX + s for s in SPANS)


def read(ctx):
    return device_ms_a_step(ctx, SPANS)
