"""hybrid_site_ms.train: the device time a step of the hybrid sites' dense
work around their attention, forward and remat rerun: the spans
``repro_torch.hybrid.pre`` (the concatenation with the embeddings, its
norm, q/k/v and RoPE) and ``repro_torch.hybrid.post`` (o, the norm, the
adapted MLP and the site's linear).  Their backward is not in them."""

from portbench.program_spans import PREFIX, device_ms_a_step

SPANS = ("hybrid.pre", "hybrid.post")
OPS = tuple(PREFIX + s for s in SPANS)


def read(ctx):
    return device_ms_a_step(ctx, SPANS)
