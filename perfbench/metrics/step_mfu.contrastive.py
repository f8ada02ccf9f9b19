"""The whole update's share of one card's peak: one card's work of an
update (``roofline_contrastive.update_work``: its products at the TF32
peak under ``precision='default'``, the rest at the f32 peak) at peak,
over the window's measured time per update, in percent."""

from perfbench import roofline_contrastive as rc


def read(ctx):
    w, t, c = ctx.work, ctx.traffic, ctx.config
    if not w.get("updates"):
        return None
    N, n = t["global_batch"], t["ranks"]
    work = rc.update_work(N // n, N, t["modalities"], c["embed_dim"],
                          c["proj_dim"], c["precision"])
    return 100.0 * ctx.roofline.ops_s(work) / (w["elapsed_s"] / w["updates"])
