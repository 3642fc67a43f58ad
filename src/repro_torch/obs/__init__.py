"""Telemetry for the engine and the serving stack (port of ``repro.obs``):
a :class:`MetricRegistry` of labelled counters, gauges and fixed-bucket
histograms with a process default (``obs.metrics``), and nestable
:func:`span` markers that open ``torch.profiler.record_function`` ranges
behind the ``SPLIDT_OBS`` switch (``obs.trace``).  The reporter
(``MetricsReporter``) and the Prometheus / JSON exposition are not ported
yet (ROADMAP A.10).
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    exp_edges,
    get_registry,
    set_registry,
)
from .trace import enabled, reset_spans, set_enabled, span, span_totals

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "enabled",
    "exp_edges",
    "get_registry",
    "reset_spans",
    "set_enabled",
    "set_registry",
    "span",
    "span_totals",
]
