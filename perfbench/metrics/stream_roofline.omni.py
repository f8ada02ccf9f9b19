"""The streamed split's kernels' share of their roofline: the bytes one
update's streamed forward and backward must move
(``roofline_omni.stream_bytes``, ``mix`` and ``d_mix`` in bf16 at
``precision='default'``) at the card's memory bandwidth, over the device
time per update of the kernels whose names hold ``stream_mix`` or
``stream_bwd`` in the traced stretch, in percent.  Silent when the trace
holds no such kernel."""

from perfbench import roofline_omni as ro

KERNELS = ("stream_mix", "stream_bwd")


def read(ctx):
    tr, t, c = ctx.trace, ctx.traffic, ctx.config
    if tr is None:
        return None
    updates = tr.counted.get("updates", 0)
    device = tr.device_s(lambda name: any(k in name for k in KERNELS))
    if updates <= 0 or device <= 0:
        return None
    mix_bytes = 2 if c["precision"] == "default" else 4
    least = ro.stream_bytes(t["batch"], t["modalities"], c["embed_dim"],
                            mix_bytes) / ctx.roofline.HBM_BYTES_PER_S
    return 100.0 * least / (device / updates)
