"""taylor_attention.roofline: the Taylor attention's share of its roofline in
the traced window, whatever computed it: the frozen least time of every
forward call (``counts/taylor.py``'s ``fwd``) and every backward call (its
``bwd`` pair) at the cell's launch, over the device time of every kernel the
calls launched (``counts/roofline.py``).  The calls are those of the torch
chunked scan's spans ``repro_torch.attention.scan`` (forward, remat reruns
included) and ``repro_torch.attention.scan.bwd`` (its recompute backward),
and those of the ops ``repro_torch::taylor_fwd`` and ``taylor_bwd_dq`` /
``taylor_bwd_dkv`` (a backward call: one of each)."""

from portbench.counts import peaks, roofline, taylor
from portbench.program_spans import PREFIX

FWD = (PREFIX + "attention.scan", "repro_torch::taylor_fwd")
BWD = (PREFIX + "attention.scan.bwd", "repro_torch::taylor_bwd_dq")
OPS = FWD + BWD + ("repro_torch::taylor_bwd_dkv",)


def read(ctx):
    shape = roofline.launch(ctx)
    op_calls = (ctx.get("trace") or {}).get("op_calls") or {}
    if shape is None:
        return None
    itemsize = 2 if ctx["cell"]["precision"]["dtype"] in ("bfloat16", "float16") else 4
    calls = lambda names: sum(len(op_calls.get(op) or []) for op in names)
    device = sum(c["device_s"] for op in OPS for c in op_calls.get(op) or [])
    if not calls(FWD) or not calls(BWD) or device <= 0:
        return None
    least = (calls(FWD) * peaks.least_seconds(*taylor.fwd(*shape, itemsize))
             + calls(BWD) * peaks.least_seconds(*taylor.bwd(*shape, itemsize)["pair"]))
    return 100.0 * least / device
