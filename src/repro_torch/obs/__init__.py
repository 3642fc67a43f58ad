"""Telemetry for the serving stack (port of ``repro.obs``): a
:class:`MetricRegistry` of counters, gauges and fixed-bucket histograms
(``obs.metrics``) and nestable :func:`span` markers that open
``torch.profiler.record_function`` ranges (``obs.trace``).  The JSONL /
Prometheus reporter is not ported yet (ROADMAP A.10).
"""
from .metrics import Counter, Gauge, Histogram, MetricRegistry, exp_edges
from .trace import reset_spans, span, span_totals

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "exp_edges",
    "reset_spans",
    "span",
    "span_totals",
]
