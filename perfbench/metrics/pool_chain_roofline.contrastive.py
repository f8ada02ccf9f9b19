"""The pool's two-pass chains' share of their roofline on rank 0's card:
the least time of one update's pool forward and backward
(``roofline_contrastive.pool_chain_work``) over the device time per update
of the chains' kernels (the port's ``aecf`` kernels: the projections'
and the loss's products run in cuBLAS and are not counted), updates
counted by the forward wrapper's launches in the traced stretch, in
percent.  Silent when the trace holds no chain kernel or no chain
launched."""

from perfbench import roofline_contrastive as rc

CHAIN = ("aecf::", "_ZN4aecf")


def read(ctx):
    tr, t, c = ctx.trace, ctx.traffic, ctx.config
    if tr is None:
        return None
    fwd = tr.counted.get("shared_query_fwd.launches", 0)
    bwd = tr.counted.get("shared_query_bwd.launches", 0)
    device = tr.device_s(lambda name: any(k in name for k in CHAIN))
    if fwd <= 0 or fwd != bwd or device <= 0:
        return None
    rf = ctx.roofline
    bound, _ = rf.bound_s(rc.pool_chain_work(
        t["global_batch"] // t["ranks"], t["modalities"], c["embed_dim"],
        c["precision"]))
    return 100.0 * bound / (device / fwd)
