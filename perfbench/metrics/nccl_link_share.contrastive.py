"""How much of the link the collectives use while they run on rank 0's
card: the bytes the traced stretch's collectives put on the link by
NCCL's bus-bandwidth convention (``roofline_contrastive.bus_bytes``, from
the program's collective counters) over the NCCL kernels' device time, as
a share of the per-direction NVLink peak of a card
(``roofline_contrastive.NVLINK_BYTES_PER_S``: 18 links of 26.562 GB/s,
read with ``nvidia-smi nvlink --status`` on the machine), in percent.
Silent when the trace holds no NCCL kernel or no collective was
counted."""

from perfbench import roofline_contrastive as rc


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    busy = rc.nccl_s(tr)
    moved = rc.bus_bytes(tr.counted, ctx.traffic["ranks"])
    if busy <= 0 or moved <= 0:
        return None
    return 100.0 * moved / busy / rc.NVLINK_BYTES_PER_S
