"""Make the registry consumable: periodic JSONL dumps + scrape endpoint
(a copy of ``repro.obs.reporter``).

``MetricsReporter`` runs a daemon thread that appends one JSON object
per interval to a file (each line a full ``snapshot()`` plus a
monotonic sequence number), and can optionally serve the Prometheus
text exposition over ``http.server`` for ad-hoc ``curl`` scrapes.
Both consumers only *read* the registry, which is single-writer by
design: no locks, no impact on the serving loop.  Nothing starts until
the reporter is constructed.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricRegistry, get_registry

__all__ = ["MetricsReporter"]


class MetricsReporter:
    """Periodic JSONL snapshot writer with an optional HTTP endpoint
    (bound to 127.0.0.1; ``http_port=0`` takes any free port, read back
    from :attr:`http_port`).

    >>> import tempfile, os
    >>> reg = MetricRegistry()
    >>> reg.counter("demo_total").inc(3)
    >>> path = os.path.join(tempfile.mkdtemp(), "metrics.jsonl")
    >>> rep = MetricsReporter(path, registry=reg, interval_s=3600.0)
    >>> rep.dump_once()
    >>> rep.close()
    >>> json.loads(open(path).readline())["counters"]["demo_total"]["value"]
    3
    """

    def __init__(self, path: Optional[str] = None, *,
                 registry: Optional[MetricRegistry] = None,
                 interval_s: float = 10.0,
                 http_port: Optional[int] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.registry = registry if registry is not None else get_registry()
        self.path = path
        self.interval_s = float(interval_s)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        if http_port is not None:
            self._start_http(http_port)

    # -- JSONL dumps -------------------------------------------------------
    def dump_once(self) -> None:
        """Append one snapshot line now (also used by the timer loop)."""
        if self.path is None:
            return
        snap = self.registry.snapshot()
        snap["seq"] = self._seq
        self._seq += 1
        with open(self.path, "a") as fh:
            fh.write(json.dumps(snap, sort_keys=True) + "\n")

    def start(self) -> "MetricsReporter":
        """Start the periodic dump thread (daemon; ``close()`` stops it)."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="splidt-metrics-reporter", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.dump_once()

    # -- HTTP text endpoint ------------------------------------------------
    def _start_http(self, port: int) -> None:
        registry = self.registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                body = registry.to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass  # keep scrapes out of stderr

        self._server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._http_thread = threading.Thread(
            target=self._server.serve_forever,
            name="splidt-metrics-http", daemon=True)
        self._http_thread.start()

    @property
    def http_port(self) -> Optional[int]:
        """Bound port of the scrape endpoint (None when not serving)."""
        if self._server is None:
            return None
        return self._server.server_address[1]

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop threads; flush one final snapshot line."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=2.0)
            self._http_thread = None
        self.dump_once()

    def __enter__(self) -> "MetricsReporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
