"""mamba_ms.train: the device time a step of the Mamba2 mixers' forward,
remat reruns included (span ``repro_torch.mamba``: in_proj, the conv, the
chunked SSD, the gated norm and out_proj).  Their backward is not in it."""

from portbench.program_spans import PREFIX, device_ms_a_step

SPANS = ("mamba",)
OPS = tuple(PREFIX + s for s in SPANS)


def read(ctx):
    return device_ms_a_step(ctx, SPANS)
