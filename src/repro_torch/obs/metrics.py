"""Process-local metrics: counters, gauges, fixed-bucket histograms (a
copy of the part of ``repro.obs.metrics`` the flow-table server uses).

The registry is the single source of runtime truth for the serving
stack: ``ServerStats`` is a thin view over it.  Every cell is a Python
int or a numpy buffer; ``Histogram.record_many`` is one
``np.searchsorted`` plus one ``np.add.at`` whatever the sample count.
A snapshot is plain ``dict``/``list``/``float`` data, so two runs over
the same ``PacketStream`` compare key by key.  The Prometheus/JSON
exposition, snapshot deltas and the process-global registry are not
ported (each server owns its registry).

>>> reg = MetricRegistry()
>>> reg.counter("serve_packets_total", "packets ingested").inc(128)
>>> reg.counter("serve_packets_total").value
128
>>> h = reg.histogram("serve_ttd_seconds", edges=[0.001, 0.01, 0.1, 1.0])
>>> h.record_many([0.0005, 0.05, 0.05, 2.0])
>>> [int(c) for c in h.counts]
[1, 0, 2, 0, 1]
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "exp_edges",
]


def exp_edges(lo: float, hi: float, n: int) -> List[float]:
    """``n`` exponentially spaced bucket edges from ``lo`` to ``hi``."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError("need 0 < lo < hi and n >= 2")
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return [lo * ratio ** i for i in range(n)]


class Counter:
    """Monotonic int counter.  ``inc`` only; never decreases."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, by: int = 1) -> None:
        if by < 0:
            raise ValueError("counters only go up")
        self.value += by


class Gauge:
    """A settable float — last write wins."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram over ``edges`` (sorted, ascending).

    ``counts`` has ``len(edges) + 1`` cells: cell ``i`` holds the
    samples ``x`` with ``edges[i-1] <= x < edges[i]`` (numpy
    ``searchsorted(side="right")``), the last cell is the +Inf
    overflow.  Bucketing is vectorised; a million samples cost one
    searchsorted + one scatter-add.
    """

    __slots__ = ("name", "help", "edges", "counts", "total", "sum")

    def __init__(self, name: str, help: str = "",
                 edges: Sequence[float] = ()):
        e = np.asarray(list(edges), dtype=np.float64)
        if e.ndim != 1 or e.size < 1 or np.any(np.diff(e) <= 0):
            raise ValueError("edges must be a non-empty ascending 1-d "
                             "sequence")
        self.name = name
        self.help = help
        self.edges = e
        self.counts = np.zeros(e.size + 1, dtype=np.int64)
        self.total = 0
        self.sum = 0.0

    def record_many(self, values) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self.edges, v, side="right")
        np.add.at(self.counts, idx, 1)
        self.total += int(v.size)
        self.sum += float(v.sum())


class MetricRegistry:
    """Name → metric map with get-or-create accessors.

    Re-asking for a name returns the same live object, so call sites
    never cache metric handles unless they are hot.  (The JAX package's
    labelled metrics are not ported: the server uses none.)
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str, help: str = "") -> Counter:
        m = self._counters.get(name)
        if m is None:
            m = self._counters[name] = Counter(name, help)
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._gauges.get(name)
        if m is None:
            m = self._gauges[name] = Gauge(name, help)
        return m

    def histogram(self, name: str, help: str = "",
                  edges: Sequence[float] = ()) -> Histogram:
        m = self._histograms.get(name)
        if m is None:
            if not edges:
                raise ValueError(
                    f"first use of histogram {name!r} must pass edges")
            m = self._histograms[name] = Histogram(name, help, edges)
        return m

    # -- views -------------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Plain-data copy of every metric (safe to mutate / serialise)."""
        counters = {name: {"value": c.value, "help": c.help}
                    for name, c in sorted(self._counters.items())}
        gauges = {name: {"value": g.value, "help": g.help}
                  for name, g in sorted(self._gauges.items())}
        histograms = {}
        for name, h in sorted(self._histograms.items()):
            histograms[name] = {
                "edges": [float(e) for e in h.edges],
                "counts": [int(c) for c in h.counts],
                "total": h.total,
                "sum": h.sum,
                "help": h.help,
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}
