"""taylor_bwd.roofline: the backward pair's share of its roofline in the
traced window: the least times of every call of ``repro_torch::taylor_bwd_dq``
and ``repro_torch::taylor_bwd_dkv``, summed, over the device time of every
kernel they launched (``counts/roofline.py``)."""

from portbench.counts import roofline, taylor

OPS = ("repro_torch::taylor_bwd_dq", "repro_torch::taylor_bwd_dkv")


def read(ctx):
    return roofline.share(ctx, dict(zip(OPS, [lambda *a: taylor.bwd(*a)["dq"],
                                              lambda *a: taylor.bwd(*a)["dkv"]])))
