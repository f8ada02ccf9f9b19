"""The X-ray model's update as a share of the card's TF32 peak: the
model's operations an update (``roofline_xray.row_flops`` times the
batch) at the TF32 peak, over the window's measured time per update, in
percent."""

from perfbench import roofline_xray as rx


def read(ctx):
    w, t, c = ctx.work, ctx.traffic, ctx.config
    if not w.get("updates"):
        return None
    flops = t["batch"] * rx.row_flops(c["image_dim"], c["text_dim"],
                                      c["hidden_dim"], 2, c["num_classes"])
    peak_s = flops / ctx.roofline.TF32_FLOPS
    return 100.0 * peak_s / (w["elapsed_s"] / w["updates"])
