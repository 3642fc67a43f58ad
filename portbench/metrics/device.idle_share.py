"""device.idle_share (%): share of the traced window in which no kernel,
copy or fill ran on the card."""


def read(ctx):
    busy, _ = ctx.trace.busy_and_gaps()
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
