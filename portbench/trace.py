"""The traced window: ``torch.profiler`` over a bounded number of steady
calls, reduced to device operations, host activity and the window.

Device operations are the kernels, copies and fills the card ran; the
window is the benchmark's own ``record_function`` range around the
calls, which ends after a device synchronise.  Busy time is the union of
the device operations inside the window, an idle gap a stretch of the
window with none, named by the innermost host event that spans its
middle (what the host was doing while the card waited).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

WINDOW = "portbench/window"
#: longest name a breakdown keeps (kernel names carry whole signatures)
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    calls: int
    window: tuple[int, int]                   # ns
    device: list[tuple[str, int, int]]        # (name, start, end) ns
    host: list[tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def device_s(self, keep=lambda name: True) -> float:
        """Summed seconds of the device operations ``keep`` accepts,
        inside the window."""
        w0, w1 = self.window
        return sum(max(0, min(e, w1) - max(s, w0))
                   for n, s, e in self.device if keep(n)) * 1e-9

    def _intervals(self) -> np.ndarray:
        w0, w1 = self.window
        iv = np.asarray([(max(s, w0), min(e, w1)) for _, s, e in self.device
                         if e > w0 and s < w1], np.int64).reshape(-1, 2)
        return iv[np.argsort(iv[:, 0], kind="stable")]

    def busy_and_gaps(self) -> tuple[float, list[tuple[int, int]]]:
        """Seconds with some device operation running, and the idle gaps
        (start, end) in ns, inside the window."""
        busy, gaps = 0, []
        cur = self.window[0]
        for s, e in self._intervals():
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if cur < self.window[1]:
            gaps.append((cur, self.window[1]))
        return busy * 1e-9, gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle gaps
        by host activity, each ``[[name, seconds], ...]``."""
        ops = collections.Counter()
        for n, s, e in self.device:
            ops[n] += (e - s) * 1e-9
        _, gaps = self.busy_and_gaps()
        idle = collections.Counter()
        if gaps and self.host:
            names = [n for n, _, _ in self.host]
            hs = np.asarray([(s, e) for _, s, e in self.host], np.int64)
            for g0, g1 in gaps:
                mid = (g0 + g1) // 2
                inside = np.nonzero((hs[:, 0] <= mid) & (hs[:, 1] >= mid))[0]
                who = (names[inside[np.argmax(hs[inside, 0])]]
                       if inside.size else "(host code outside any traced op)")
                idle[who] += (g1 - g0) * 1e-9
        short = lambda n: n if len(n) <= NAME_CHARS else n[:NAME_CHARS] + "..."
        return {"device_ops": [[short(n), s] for n, s in ops.most_common(top)],
                "idle_gaps": [[short(n), s] for n, s in idle.most_common(top)]}


def record(call, n_calls: int) -> Trace:
    """``call(i)`` for i in ``range(n_calls)`` under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(n_calls):
                call(i)
            torch.cuda.synchronize()
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        span = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(span)
        elif e.name() == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None or not device:
        raise RuntimeError("the profiler recorded no window or no device "
                           "operation")
    return Trace(n_calls, window, device, host)
