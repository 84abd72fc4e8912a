"""device_idle.train: the share of the traced window in which no kernel, copy
or set ran on the card (the union of the device's activity intervals)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
