"""decode_block_ms.serve: the engine's mean time of one decode block in the
window (``decode_seconds`` over ``decode_dispatches``; each block timed
until its tokens reach the host)."""


def read(ctx):
    s = ctx["layer"].get("stats")
    if not s or not s.get("decode_dispatches"):
        return None
    return 1e3 * s["decode_seconds"] / s["decode_dispatches"]
