"""Process-local metrics: counters, gauges, fixed-bucket histograms (a
copy of ``repro.obs.metrics``).

The registry is the single source of runtime truth for the serving
stack: ``ServerStats`` is a thin view over it.  Every cell is a Python
int or a numpy buffer; ``Histogram.record_many`` is one
``np.searchsorted`` plus one ``np.add.at`` whatever the sample count.
A snapshot is plain ``dict``/``list``/``float`` data, so two runs over
the same ``PacketStream`` compare key by key.  Each server owns its
registry; :func:`get_registry` / :func:`set_registry` hold the process
default that the engine, the streaming scheduler, the autotuner and the
design-space search (``core.dse``) record into.  A metric's identity is
its name and its sorted labels; a snapshot keys a labelled metric as
``name{k="v",...}``, as the JAX package's registry does.  The registry
exposes itself as Prometheus text (:meth:`MetricRegistry.to_prometheus`)
and JSON (:meth:`MetricRegistry.to_json`), byte for byte what the JAX
registry writes after the same records, and two snapshots subtract
(:meth:`MetricRegistry.delta`).

>>> reg = MetricRegistry()
>>> reg.counter("serve_packets_total", "packets ingested").inc(128)
>>> reg.counter("serve_packets_total").value
128
>>> h = reg.histogram("serve_ttd_seconds", edges=[0.001, 0.01, 0.1, 1.0])
>>> h.record_many([0.0005, 0.05, 0.05, 2.0])
>>> [int(c) for c in h.counts]
[1, 0, 2, 0, 1]
>>> reg.counter("engine_dispatches_total", labels={"backend": "cuda"}).inc()
>>> sorted(reg.snapshot()["counters"])
['engine_dispatches_total{backend="cuda"}', 'serve_packets_total']
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "exp_edges",
    "get_registry",
    "set_registry",
]


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_suffix(key: LabelKey) -> str:
    if not key:
        return ""
    return "{%s}" % ",".join(f'{k}="{v}"' for k, v in key)


def exp_edges(lo: float, hi: float, n: int) -> List[float]:
    """``n`` exponentially spaced bucket edges from ``lo`` to ``hi``."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError("need 0 < lo < hi and n >= 2")
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return [lo * ratio ** i for i in range(n)]


class Counter:
    """Monotonic int counter.  ``inc`` only; never decreases."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = _label_key(labels)
        self.value = 0

    def inc(self, by: int = 1) -> None:
        if by < 0:
            raise ValueError("counters only go up")
        self.value += by


class Gauge:
    """A settable float — last write wins."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = _label_key(labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def add(self, by: float) -> None:
        self.value += float(by)


class Histogram:
    """Fixed-bucket histogram over ``edges`` (sorted, ascending).

    ``counts`` has ``len(edges) + 1`` cells: cell ``i`` holds the
    samples ``x`` with ``edges[i-1] <= x < edges[i]`` (numpy
    ``searchsorted(side="right")``), the last cell is the +Inf
    overflow.  Bucketing is vectorised; a million samples cost one
    searchsorted + one scatter-add.
    """

    __slots__ = ("name", "help", "labels", "edges", "counts", "total",
                 "sum")

    def __init__(self, name: str, help: str = "",
                 edges: Sequence[float] = (),
                 labels: Optional[Mapping[str, str]] = None):
        e = np.asarray(list(edges), dtype=np.float64)
        if e.ndim != 1 or e.size < 1 or np.any(np.diff(e) <= 0):
            raise ValueError("edges must be a non-empty ascending 1-d "
                             "sequence")
        self.name = name
        self.help = help
        self.labels = _label_key(labels)
        self.edges = e
        self.counts = np.zeros(e.size + 1, dtype=np.int64)
        self.total = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        i = int(np.searchsorted(self.edges, value, side="right"))
        self.counts[i] += 1
        self.total += 1
        self.sum += float(value)

    def record_many(self, values) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self.edges, v, side="right")
        np.add.at(self.counts, idx, 1)
        self.total += int(v.size)
        self.sum += float(v.sum())

    def quantile(self, q: float) -> float:
        """Upper bucket edge containing the ``q`` quantile (the usual
        Prometheus-style conservative estimate); NaN when empty."""
        if not (0.0 <= q <= 1.0):
            raise ValueError("q must be in [0, 1]")
        if self.total == 0:
            return float("nan")
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, q * self.total, side="left"))
        if i >= self.edges.size:
            return float("inf")
        return float(self.edges[i])

    def bucket_of(self, value: float) -> int:
        """Index of the bucket a sample would land in."""
        return int(np.searchsorted(self.edges, value, side="right"))


class MetricRegistry:
    """(name, labels) -> metric map with get-or-create accessors.

    Metric identity is ``(name, sorted(labels))``: re-asking for the same
    identity returns the same live object, whatever the order the labels
    come in, so call sites never cache metric handles unless they are hot.
    """

    def __init__(self):
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        key = (name, _label_key(labels))
        m = self._counters.get(key)
        if m is None:
            m = self._counters[key] = Counter(name, help, labels)
        return m

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        key = (name, _label_key(labels))
        m = self._gauges.get(key)
        if m is None:
            m = self._gauges[key] = Gauge(name, help, labels)
        return m

    def histogram(self, name: str, help: str = "",
                  edges: Sequence[float] = (),
                  labels: Optional[Mapping[str, str]] = None) -> Histogram:
        key = (name, _label_key(labels))
        m = self._histograms.get(key)
        if m is None:
            if not edges:
                raise ValueError(
                    f"first use of histogram {name!r} must pass edges")
            m = self._histograms[key] = Histogram(name, help, edges, labels)
        return m

    # -- views -------------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Plain-data copy of every metric (safe to mutate / serialise),
        keyed ``name{k="v",...}`` in (name, labels) order."""
        counters = {name + _label_suffix(lk): {"value": c.value,
                                               "help": c.help}
                    for (name, lk), c in sorted(self._counters.items())}
        gauges = {name + _label_suffix(lk): {"value": g.value,
                                             "help": g.help}
                  for (name, lk), g in sorted(self._gauges.items())}
        histograms = {}
        for (name, lk), h in sorted(self._histograms.items()):
            histograms[name + _label_suffix(lk)] = {
                "edges": [float(e) for e in h.edges],
                "counts": [int(c) for c in h.counts],
                "total": h.total,
                "sum": h.sum,
                "help": h.help,
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    @staticmethod
    def delta(before: Mapping[str, dict],
              after: Mapping[str, dict]) -> Dict[str, dict]:
        """Snapshot-vs-snapshot difference (counters + histogram counts;
        gauges report the *after* value)."""
        out: Dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for k, v in after.get("counters", {}).items():
            prev = before.get("counters", {}).get(k, {}).get("value", 0)
            out["counters"][k] = {"value": v["value"] - prev}
        for k, v in after.get("gauges", {}).items():
            out["gauges"][k] = {"value": v["value"]}
        for k, v in after.get("histograms", {}).items():
            prev = before.get("histograms", {}).get(k)
            pc = prev["counts"] if prev else [0] * len(v["counts"])
            out["histograms"][k] = {
                "edges": v["edges"],
                "counts": [a - b for a, b in zip(v["counts"], pc)],
                "total": v["total"] - (prev["total"] if prev else 0),
                "sum": v["sum"] - (prev["sum"] if prev else 0.0),
            }
        return out

    # -- exposition --------------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of the whole registry.
        ``# HELP`` and ``# TYPE`` lines head the unlabelled metric of a
        name only, as the JAX registry writes them."""
        lines: List[str] = []
        for (name, lk), c in sorted(self._counters.items()):
            if c.help and not lk:
                lines.append(f"# HELP {name} {c.help}")
            if not lk:
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_label_suffix(lk)} {c.value}")
        for (name, lk), g in sorted(self._gauges.items()):
            if g.help and not lk:
                lines.append(f"# HELP {name} {g.help}")
            if not lk:
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_label_suffix(lk)} {_fmt(g.value)}")
        for (name, lk), h in sorted(self._histograms.items()):
            if h.help and not lk:
                lines.append(f"# HELP {name} {h.help}")
            if not lk:
                lines.append(f"# TYPE {name} histogram")
            cum = 0
            base = dict(lk)
            for edge, cnt in zip(h.edges, h.counts[:-1]):
                cum += int(cnt)
                le = _label_suffix(_label_key({**base, "le": _fmt(edge)}))
                lines.append(f"{name}_bucket{le} {cum}")
            cum += int(h.counts[-1])
            le = _label_suffix(_label_key({**base, "le": "+Inf"}))
            lines.append(f"{name}_bucket{le} {cum}")
            lines.append(f"{name}_sum{_label_suffix(lk)} {_fmt(h.sum)}")
            lines.append(f"{name}_count{_label_suffix(lk)} {h.total}")
        return "\n".join(lines) + "\n"


def _fmt(x: float) -> str:
    """A sample value as Prometheus text: integral values without a
    fraction, infinities as ``+Inf`` / ``-Inf``, NaN as ``NaN``, else
    ``repr``.  (The JAX package's ``_fmt`` raises on NaN, at
    ``int(x)``; a gauge set to NaN would break its whole exposition.)"""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    if float(x) == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


_DEFAULT = MetricRegistry()


def get_registry() -> MetricRegistry:
    """The process default registry."""
    return _DEFAULT


def set_registry(reg: MetricRegistry) -> MetricRegistry:
    """Install ``reg`` as the process default; returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = reg
    return prev
