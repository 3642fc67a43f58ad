"""Watch the port's serving stack run: metrics scrape + span tree + audit.

    PYTHONPATH=src python examples/observe_serving_torch.py [--smoke]
    PYTHONPATH=src python examples/observe_serving_torch.py --device cpu

Trains a small SpliDT model, serves a synthetic packet stream through
:class:`repro_torch.serve.FlowTableServer` (the tick kernel on the card,
the plain tick on the CPU), and then shows every face of the
observability stack:

1. a **Prometheus scrape** -- the reporter exposes the server's
   ``MetricRegistry`` over ``http.server`` on 127.0.0.1 and we fetch it;
2. the **span tree** -- where the wall-clock went inside each ingest
   tick (admit / pack / dispatch / fetch / spill);
3. the **audit**: the live ``serve_recirc_overhead`` gauge is
   recomputed offline from the raw :class:`StreamVerdicts` the server
   returned; the two must agree exactly, and the script exits nonzero
   when they drift.

The lines printed are those of ``examples/observe_serving.py``.
``--smoke`` shrinks everything.  ``--device`` defaults to the card;
without one it raises.
"""
import argparse
import urllib.request

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny sizes")
    ap.add_argument("--flows", type=int, default=2000)
    ap.add_argument("--ticks", type=int, default=257)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.flows, args.ticks = 300, 61

    from repro_torch import obs
    from repro_torch.core.inference import Engine
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.device import resolve_device
    from repro_torch.flows.synthetic import make_dataset, make_packet_stream
    from repro_torch.flows.windows import window_features
    from repro_torch.serve import FlowTableServer, StreamVerdicts

    dev = resolve_device(args.device)
    print("=== SpliDT serving observability ===")
    obs.set_enabled(True)
    obs.reset_spans()

    ds = make_dataset("d2", n_flows=args.flows)
    tr, _ = ds.split()
    Xw = window_features(tr, 3, device=dev)
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[2, 3, 2], k=4)
    eng = Engine.from_model(pdt, device=dev)

    srv = FlowTableServer(eng, n_buckets=32, bucket_size=8)
    stream = make_packet_stream(tr, seed=11, profile="steady")
    parts = [srv.ingest(b) for b in stream.ticks(args.ticks)]
    parts.append(srv.flush())
    verdicts = StreamVerdicts.concat(parts)
    print(f"served {srv.stats.packets} packets -> "
          f"{verdicts.n_flows} verdicts in {srv.stats.ticks} ticks "
          f"({srv.stats.dispatches} device dispatches)")

    # -- 1. Prometheus scrape over HTTP ---------------------------------
    rep = obs.MetricsReporter(None, registry=srv.registry, http_port=0)
    try:
        url = f"http://127.0.0.1:{rep.http_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
    finally:
        rep.close()
    print(f"\n--- scrape of {url} (serve_* lines) ---")
    scraped = []
    for line in body.splitlines():
        if line.startswith(("serve_", "# TYPE serve_")) \
                and "_bucket" not in line:
            scraped.append(line)
            print(" ", line)

    # -- 2. where the time went: the span tree --------------------------
    print("\n--- span tree (host wall-clock per ingest stage) ---")
    print(obs.span_tree())

    # -- 3. audit: live gauge == offline recompute from raw verdicts ----
    recircs = int(np.asarray(verdicts.recircs, np.int64).sum())
    offline = recircs / srv.stats.packets
    live = srv.registry.gauge("serve_recirc_overhead").value
    print("\n--- recirc-overhead audit ---")
    print(f"  offline: {recircs} recircs / {srv.stats.packets} packets "
          f"= {offline:.6f}")
    print(f"  live gauge serve_recirc_overhead = {live:.6f}")
    out = {"device": str(dev), "packets": srv.stats.packets,
           "verdicts": verdicts.n_flows, "ticks": srv.stats.ticks,
           "dispatches": srv.stats.dispatches, "scrape": scraped,
           "recircs": recircs, "offline": offline, "live": live,
           "audit_clean": live == offline}
    if live != offline:
        print("MISMATCH: live metrics drifted from the raw verdicts")
        return out
    ttd = srv.registry.histogram(
        "serve_ttd_seconds", edges=obs.exp_edges(1e-3, 1e4, 15))
    print(f"  TTD: p50 <= {ttd.quantile(0.5):.4g}s, "
          f"p99 <= {ttd.quantile(0.99):.4g}s over {ttd.total} verdicts")
    print("\nlive metrics match the offline recompute — audit clean")
    out.update(ttd_p50=ttd.quantile(0.5), ttd_p99=ttd.quantile(0.99),
               ttd_total=ttd.total)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["audit_clean"] else 1)
