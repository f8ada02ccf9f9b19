"""The one-pass step chain's share of its roofline: the least time of the
step's work (``roofline.step_work``) over the device time per update of
the chain's kernels (the port's ``aecf`` kernels and the step's head
kernel) in the traced stretch, in percent.  Silent when the trace holds
no chain kernel or no chain launched."""

CHAIN = ("aecf::", "_ZN4aecf", "step_head_kernel")


def read(ctx):
    tr, t, c = ctx.trace, ctx.traffic, ctx.config
    if tr is None:
        return None
    launches = tr.counted.get("train_step.launches", 0)
    device = tr.device_s(lambda name: any(k in name for k in CHAIN))
    if launches <= 0 or device <= 0:
        return None
    rf = ctx.roofline
    bound, _ = rf.bound_s(rf.step_work(t["batch"], t["modalities"],
                                       c["embed_dim"], c["num_classes"],
                                       c["precision"]))
    return 100.0 * bound / (device / launches)
