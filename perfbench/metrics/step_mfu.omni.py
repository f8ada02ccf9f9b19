"""The omni late-fusion update as a share of the card's TF32 peak: the
update's operations (``roofline_omni.update_work``) at the TF32 peak, over
the window's measured time per update, in percent."""

from perfbench import roofline_omni as ro


def read(ctx):
    w, t, c = ctx.work, ctx.traffic, ctx.config
    if not w.get("updates"):
        return None
    flops = ro.update_work(t["batch"], t["modalities"], c["embed_dim"],
                           c["num_classes"])
    peak_s = flops / ctx.roofline.TF32_FLOPS
    return 100.0 * peak_s / (w["elapsed_s"] / w["updates"])
