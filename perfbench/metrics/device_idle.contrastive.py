"""The device's idle share of the traced stretch on rank 0's card: no
kernel and no copy running, in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
