"""The draw kernels' share of their roofline: the bytes of one update's
draws (``roofline_xray.draws_bytes``) at the card's memory bandwidth, over
the device time per update of the kernels whose name holds
``philox_draws`` in the traced stretch, in percent.  Silent when the trace
holds no such kernel."""

from perfbench import roofline_xray as rx

KERNEL = "philox_draws"


def read(ctx):
    tr, t, c = ctx.trace, ctx.traffic, ctx.config
    if tr is None:
        return None
    updates = tr.counted.get("updates", 0)
    device = tr.device_s(lambda name: KERNEL in name)
    if updates <= 0 or device <= 0:
        return None
    least = rx.draws_bytes(t["batch"], c["hidden_dim"], 2) \
        / ctx.roofline.HBM_BYTES_PER_S
    return 100.0 * least / (device / updates)
