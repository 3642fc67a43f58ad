"""walk_mfu (%): the least time of a batch's work (``ref/work.py``: its
packets, verdicts and trees over the card's peak bytes/s or f32
operations/s, the larger) over the mean wall time of one ``Engine.run``
in the traced window.  The whole call's share of the card's peak."""


def read(ctx):
    if ctx.least_s is None or ctx.calls == 0:
        return None
    return 100.0 * ctx.least_s / (ctx.trace.window_s / ctx.calls)
