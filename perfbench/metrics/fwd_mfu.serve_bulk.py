"""The served forward's share of the card's f32 peak: the operations of a
row (``roofline.vl_row_flops``: the encoders, the pool, the classifier)
times the window's rows a second, in percent."""


def read(ctx):
    w, c = ctx.work, ctx.config
    if not w.get("rows"):
        return None
    rf = ctx.roofline
    flops = rf.vl_row_flops(c["img_dim"], c["txt_dim"], c["hidden_dim"],
                            c["num_classes"])
    return 100.0 * flops * w["rows"] / w["elapsed_s"] / rf.F32_FLOPS
