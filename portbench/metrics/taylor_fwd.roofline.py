"""taylor_fwd.roofline: the forward kernel's share of its roofline in the
traced window, over every call of the dispatcher op
``repro_torch::taylor_fwd`` (``counts/roofline.py``)."""

from portbench.counts import roofline, taylor

OPS = ("repro_torch::taylor_fwd",)


def read(ctx):
    return roofline.share(ctx, dict(zip(OPS, [taylor.fwd])))
