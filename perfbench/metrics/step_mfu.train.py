"""The whole update's share of the card's peak: the one-pass step's work
(``roofline.step_work``: its products at the TF32 peak under
``precision='default'``, the rest at the f32 peak) at peak, over the
window's measured time per update, in percent."""


def read(ctx):
    w, t, c = ctx.work, ctx.traffic, ctx.config
    if not w.get("updates"):
        return None
    rf = ctx.roofline
    work = rf.step_work(t["batch"], t["modalities"], c["embed_dim"],
                        c["num_classes"], c["precision"])
    return 100.0 * rf.ops_s(work) / (w["elapsed_s"] / w["updates"])
