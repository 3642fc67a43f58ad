"""Nestable wall-clock spans that line up with device traces (a port of
``repro.obs.trace``'s ``span``).

``span("tick/dispatch")`` times a host-side region and, while a
``torch.profiler`` records, opens a ``torch.profiler.record_function``
range of the same name, so the trace attributes the device work the
region launched to ``tick/admit``, ``tick/pack``, ``tick/dispatch`` or
``tick/fetch``.  With no profiler running the range is not opened: it
would record nothing and costs more host time than the rest of the span.
Spans nest: a span entered inside another is recorded under it;
:func:`span_tree` renders the accumulated hierarchy as the JAX package
does and :func:`span_totals` reads the calls and seconds per path.

The switch is the ``SPLIDT_OBS`` environment variable, read once at
import and flipped at run time with :func:`set_enabled`: off, :func:`span`
returns one shared no-op context manager and :func:`enabled` tells
callers to skip their own wall-clock timing.  The host clock says when work was enqueued, not when the card
ran it: a span that must cover device time has to end in a host fetch,
as ``tick/fetch`` does.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["SpanNode", "enabled", "reset_spans", "set_enabled", "span",
           "span_totals", "span_tree"]

_ENABLED = os.environ.get("SPLIDT_OBS", "1") not in ("0", "false", "off")


def enabled() -> bool:
    """Is observability timing currently on?"""
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip the global switch; returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


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

    def render(self, indent: int = 0) -> List[str]:
        lines = []
        if self.name:
            lines.append("%s%-28s %8d calls  %10.3f ms" % (
                "  " * indent, self.name, self.count,
                self.total_s * 1e3))
        for key in sorted(self.children):
            lines.extend(self.children[key].render(
                indent + (1 if self.name else 0)))
        return lines


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
        # PyTorch's own fast check of a running profiler (dynamo and
        # inductor read it the same way)
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
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


def span_tree() -> str:
    """Render this thread's accumulated span hierarchy."""
    lines = _STATE.root.render()
    if not lines:
        return "(no spans recorded)"
    return "\n".join(lines)


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
