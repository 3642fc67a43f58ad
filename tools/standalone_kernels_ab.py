#!/usr/bin/env python3
"""Time kernel B and the per-packet fold of one checkout's port on the
card, as their callers call them: the parent-vs-change A/B that
``chip_smoke.py`` cannot make.

    python3 tools/standalone_kernels_ab.py --src SRC --tag TAG

``SRC`` is the ``src`` directory of the checkout under test (its
``repro_torch`` is imported; its kernels are built into its own
``build/``); the timing helpers come from this checkout's
``chip_smoke.py``.  An older commit is timed by the same script: unpack
it with ``git archive`` into a directory ``.gitignore`` lists and give
its ``src``.  Run the commits in turns (A, B, B, A) in one call to the
card.

On phase ``main``'s engine (``make_dataset("d2", 6000)``, (3, 3, 3),
k = 4, the test windows tiled to 2^20 flows) it records, by graph replay
(device time) with each call's kernel nodes, and by CUDA events:

* kernel B as called: ``dispatch.dispatch_dt_traverse`` and
  ``ops.dt_traverse_dev`` on hop 1's registers from random SIDs, at 2^20
  flows and at the serving width (16,384);
* the fold as the legacy tick engine calls it: ``feature_update_at`` on
  pre-gathered slot rows and ``serve.flowtable._fold_rank`` on the
  SID-keyed tables, at the serving width on a 2^18-slot table (the last
  37 entries dummy-row padding) and at 2^20 rows;
* the legacy tick engine's server (``tick_engine="legacy"``, the
  kernels) on phase ``serve_check``'s 1,024-flow prefix: seconds a tick
  (median of the second of two runs) and the run's total;
* ``Engine.run_looped`` at 2^20 flows (host clock) and the two-kernel
  walk (``step_hop(ops.cuda_step(128))``) on the device (events).

Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVING_C = 16384
PAD = 37


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("standalone_kernels_ab: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.inference import (
        Engine, EngineOptions, partition_walk,
    )
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.flows.synthetic import (
        FlowDataset, make_dataset, make_packet_stream,
    )
    from repro_torch.flows.windows import window_features, window_packets
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels import feature_window as fw
    from repro_torch.kernels.engine_hop import step_hop
    from repro_torch.serve import FlowTableServer
    from repro_torch.serve.flowtable import _fold_rank

    card = torch.device("cuda")
    t_start = time.perf_counter()
    out = {"tag": args.tag, "src": args.src, "card": cs.nvidia_smi()}
    ds = make_dataset("d2", 6000)
    tr, te = ds.split()
    pdt = train_partitioned_dt(window_features(tr, 3, device="cpu"),
                               tr.labels, partition_sizes=[3, 3, 3], k=4)
    eng = Engine.from_model(pdt)
    dev = eng.tables.dev
    S, k, _ = dev.thresholds.shape
    wp = window_packets(te, 3)
    wp = np.tile(wp, (-(-cs.B_MAIN // wp.shape[0]), 1, 1, 1))[:cs.B_MAIN]
    x = torch.from_numpy(wp).to(card)
    g = torch.Generator(device=card).manual_seed(0)
    sid = torch.randint(0, S, (cs.B_MAIN,), generator=g, device=card,
                        dtype=torch.int32)
    regs = ops.feature_window_dev(x[:, 1], sid, dev)

    def timed(fn, n: int) -> dict:
        return {"graph_ms": cs.graph_ms(fn, n),
                "events_ms": cs.cuda_ms(fn, reps=20, warmup=3),
                "kernel_nodes": cs.graph_kernel_nodes(fn)}

    # -- kernel B as called -------------------------------------------------
    kb = {}
    for tag, n in (("2^20", cs.B_MAIN), ("serving", SERVING_C)):
        r, s_ = regs[:n].contiguous(), sid[:n].contiguous()
        kb[tag] = {
            "dispatch_dt_traverse": timed(
                lambda: dispatch.dispatch_dt_traverse(r, s_, *dev[4:],
                                                      block_b=128), 20),
            "dt_traverse_dev": timed(
                lambda: ops.dt_traverse_dev(r, s_, dev), 20)}
    out["kernel_b"] = kb

    # -- the fold as the legacy tick engine calls it ------------------------
    fold = {}
    for tag, N, C in (("serving", 1 << 18, SERVING_C),
                      ("2^20", 1 << 20, 1 << 20)):
        acc = torch.zeros(N + 1, k, device=card)
        seen = torch.zeros(N + 1, k, dtype=torch.int32, device=card)
        slots = torch.full((C,), N, dtype=torch.int32, device=card)
        n_real = C - PAD
        slots[:n_real] = torch.randperm(N, generator=g, device=card)[
            :n_real].to(torch.int32)
        s_ = torch.zeros(C, dtype=torch.int32, device=card)
        s_[:n_real] = sid[:n_real]
        pkt = torch.zeros(C, 6, device=card)
        pkt[:n_real] = x[:n_real, 1, 0]
        rows = tuple(t[s_.long()] for t in dev[:3])
        fold[tag] = {
            "feature_update_at": timed(
                lambda: fw.feature_update_at(acc, seen, slots, pkt, *rows),
                20),
            "fold_rank": timed(
                lambda: _fold_rank(acc, seen, pkt, s_, slots, dev,
                                   cuda=True), 20)}
    out["fold"] = fold

    # -- the legacy tick engine on serve_check's prefix ---------------------
    ds_s = make_dataset("d2", cs.SERVE_FLOWS, seed=1)
    sub = slice(0, cs.CHECK_FLOWS)
    ds_p = FlowDataset(ds_s.packets[sub], ds_s.lengths[sub],
                       ds_s.labels[sub], ds_s.n_classes, ds_s.name)
    stream_p = make_packet_stream(ds_p, seed=7, profile="steady",
                                  concurrency=cs.CHECK_CONCURRENCY)
    ticks = list(stream_p.ticks(cs.CHECK_TICK))
    legacy = {}
    for _ in range(2):
        srv = FlowTableServer(
            eng, n_buckets=cs.CHECK_TABLE[0], bucket_size=cs.CHECK_TABLE[1],
            timeout=cs.CHECK_TIMEOUT, tick_engine="legacy",
            options=EngineOptions(impl="cuda"))
        tick_s = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in ticks:
            t1 = time.perf_counter()
            srv.ingest(b)
            tick_s.append(time.perf_counter() - t1)
        srv.flush()
        torch.cuda.synchronize()
        legacy = {"ticks": len(ticks), "run_s": time.perf_counter() - t0,
                  "tick_s_p50": statistics.median(tick_s),
                  "tick_s_mean": sum(tick_s) / len(tick_s),
                  "stats": srv.stats.as_dict()}
    out["legacy_server_prefix"] = legacy

    # -- run_looped and the two-kernel walk at 2^20 -------------------------
    out["run_looped_s"] = cs.host_s(lambda: eng.run_looped(x), reps=3)
    out["two_kernel_walk_device_ms"] = cs.cuda_ms(lambda: partition_walk(
        x, dev, hop=step_hop(ops.cuda_step(128)),
        n_subtrees=eng.tables.n_subtrees,
        n_partitions=eng.tables.n_partitions, with_trace=True))
    out["wall_s"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
