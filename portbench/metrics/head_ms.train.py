"""head_ms.train: the device time a step of the model's head: the final
norm and unembedding (span ``repro_torch.head``), the cross-entropy
(``repro_torch.loss``) and their backward (``repro_torch.head.bwd``, on the
autograd thread that launches it)."""

from portbench.program_spans import PREFIX, device_ms_a_step

SPANS = ("head", "loss", "head.bwd")
OPS = tuple(PREFIX + s for s in SPANS)


def read(ctx):
    return device_ms_a_step(ctx, SPANS)
