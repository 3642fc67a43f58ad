"""engine.dispatch_ms (ms): mean host time a call in the program's own
``engine/dispatch`` span (``Engine.run``'s walk launches: route, hops,
compaction), recorded in the traced run's span window, where no
profiler runs, so the profiler's host cost of each traced operation
stays out of the span."""

SPAN = "engine/dispatch"


def read(ctx):
    span = ctx.spans.get(SPAN)
    if not span or not span["calls"]:
        return None
    return 1e3 * span["s"] / span["calls"]
