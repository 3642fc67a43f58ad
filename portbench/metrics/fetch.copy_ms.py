"""fetch.copy_ms (ms): device-to-host copy time a batch (the verdict
buffer's copy into pinned host memory), from the trace's copies."""


def read(ctx):
    s = ctx.trace.device_s(lambda name: name.startswith("Memcpy DtoH"))
    return 1e3 * s / ctx.calls if s else None
