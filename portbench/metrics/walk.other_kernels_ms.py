"""walk.other_kernels_ms (ms): device time a batch of every operation
that is neither the hop kernel nor a copy: compaction's permutation and
count, the walk buffer's fills, the survivor sums."""

HOP = "engine_hop_kernel"


def read(ctx):
    s = ctx.trace.device_s(
        lambda name: HOP not in name and not name.startswith("Memcpy"))
    return 1e3 * s / ctx.calls if s else None
