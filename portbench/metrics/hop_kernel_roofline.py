"""hop_kernel_roofline (%): the least time of a batch's work over the
hop kernel's device time a batch (``engine_hop_kernel``, every launch of
the traced window, by name).  Nothing when the hop kernel did not run."""

HOP = "engine_hop_kernel"


def read(ctx):
    hop_s = ctx.trace.device_s(lambda name: HOP in name)
    if ctx.least_s is None or hop_s == 0:
        return None
    return 100.0 * ctx.least_s / (hop_s / ctx.calls)
