"""The share of rank 0's busy device time spent in NCCL's kernels (the
all-gather of the targets, its reduce-scatter, the gradients'
all-reduce) over the traced stretch, in percent.  Silent when the trace
holds no NCCL kernel."""

from perfbench import roofline_contrastive as rc


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    nccl = rc.nccl_s(tr)
    if nccl <= 0:
        return None
    return 100.0 * nccl / tr.busy_s
