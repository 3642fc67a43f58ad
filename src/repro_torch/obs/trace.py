"""Nestable wall-clock spans that line up with device traces (a port of
``repro.obs.trace``'s ``span``).

``span("tick/dispatch")`` times a host-side region and opens a
``torch.profiler.record_function`` range of the same name, so a
``torch.profiler`` trace attributes the device work the region launched
to ``tick/admit``, ``tick/pack``, ``tick/dispatch`` or ``tick/fetch``.
Spans nest: a span entered inside another is recorded under it, and
:func:`span_totals` reads the accumulated calls and seconds per path.

The switch is the ``SPLIDT_OBS`` environment variable, read once at
import: ``0`` makes :func:`span` return one shared no-op context
manager.  The host clock says when work was enqueued, not when the card
ran it: a span that must cover device time has to end in a host fetch,
as ``tick/fetch`` does.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["reset_spans", "span", "span_totals"]

_ENABLED = os.environ.get("SPLIDT_OBS", "1") not in ("0", "false", "off")


class SpanNode:
    """Aggregated timings for one span name at one nesting position:
    re-entering the same name under the same parent accumulates into one
    node (``count`` calls, ``total_s`` seconds)."""

    __slots__ = ("name", "count", "total_s", "children")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.children: Dict[str, "SpanNode"] = {}

    def child(self, name: str) -> "SpanNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = SpanNode(name)
        return node


class _SpanState(threading.local):
    def __init__(self):
        self.root = SpanNode("")
        self.stack: List[SpanNode] = []


_STATE = _SpanState()


class _Span:
    """Context manager for one timed region (enabled path)."""

    __slots__ = ("name", "_t0", "_node", "_range")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._node: Optional[SpanNode] = None
        self._range = None

    def __enter__(self):
        parent = _STATE.stack[-1] if _STATE.stack else _STATE.root
        self._node = parent.child(self.name)
        _STATE.stack.append(self._node)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        self._range = None
        node = self._node
        node.count += 1
        node.total_s += dt
        _STATE.stack.pop()
        return False


class _NullSpan:
    """Shared no-op context: the whole disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name: str):
    """Open a timed region: ``with span("tick/admit"): ...``.  A shared
    no-op context when ``SPLIDT_OBS=0``."""
    if not _ENABLED:
        return _NULL
    return _Span(name)


def span_totals() -> Dict[str, dict]:
    """This thread's accumulated spans, flattened: ``{"outer/inner path":
    {"calls": n, "s": seconds}}``, nested names joined by ``" > "``."""
    out: Dict[str, dict] = {}

    def walk(node: SpanNode, prefix: str) -> None:
        for name in sorted(node.children):
            c = node.children[name]
            path = f"{prefix} > {name}" if prefix else name
            out[path] = {"calls": c.count, "s": c.total_s}
            walk(c, path)

    walk(_STATE.root, "")
    return out


def reset_spans() -> None:
    """Drop this thread's accumulated spans (between measured runs)."""
    _STATE.root = SpanNode("")
    _STATE.stack = []
