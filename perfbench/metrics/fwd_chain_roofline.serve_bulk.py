"""The shared-query forward chain's share of its roofline at the largest
bucket: the least time of one call's work (``roofline.fwd_chain_work``,
M = 2) over the device time a call of the chain's kernels (the port's
``aecf`` kernels) in the traced stretch, in percent.  Silent when the
trace holds no chain kernel or no chain launched."""

CHAIN = ("aecf::", "_ZN4aecf")


def read(ctx):
    tr, t, c = ctx.trace, ctx.traffic, ctx.config
    if tr is None:
        return None
    launches = tr.counted.get("shared_query_fwd.launches", 0)
    device = tr.device_s(lambda name: any(k in name for k in CHAIN))
    if launches <= 0 or device <= 0:
        return None
    rf = ctx.roofline
    bound, _ = rf.bound_s(rf.fwd_chain_work(max(t["buckets"]), 2,
                                            c["hidden_dim"], c["precision"]))
    return 100.0 * bound / (device / launches)
