"""Telemetry for the engine and the serving stack (port of ``repro.obs``):

* :mod:`repro_torch.obs.metrics` -- a :class:`MetricRegistry` of labelled
  counters, gauges and fixed-bucket histograms with a process default,
  snapshot deltas, and Prometheus-text and JSON exposition;
* :mod:`repro_torch.obs.trace` -- nestable wall-clock :func:`span` hooks
  that open ``torch.profiler.record_function`` ranges, behind the
  ``SPLIDT_OBS`` switch, and the rendered :func:`span_tree`;
* :mod:`repro_torch.obs.reporter` -- :class:`MetricsReporter`, a periodic
  JSONL dumper with an optional ``http.server`` scrape endpoint.

Counters and gauges always record; only wall-clock timing -- spans and
latency-histogram fills -- honours the ``SPLIDT_OBS`` switch.
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
from .reporter import MetricsReporter
from .trace import (
    SpanNode,
    enabled,
    reset_spans,
    set_enabled,
    span,
    span_totals,
    span_tree,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "MetricsReporter",
    "SpanNode",
    "enabled",
    "exp_edges",
    "get_registry",
    "reset_spans",
    "set_enabled",
    "set_registry",
    "span",
    "span_totals",
    "span_tree",
]
