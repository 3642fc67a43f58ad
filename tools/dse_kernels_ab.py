#!/usr/bin/env python3
"""Time the design-space search's two kernels of one checkout's port on
the card: the parent-vs-change A/B that ``chip_smoke.py`` cannot make,
and the crossover between the hop kernel's two matches.

    python3 tools/dse_kernels_ab.py --src SRC --tag TAG

``SRC`` is the ``src`` directory of the checkout under test (its
``repro_torch`` is imported; its kernels are built into its own
``build/``); the timing helpers come from this checkout's
``chip_smoke.py``.  An older commit is timed by the same script: unpack
it with ``git archive`` into a directory ``.gitignore`` lists and give
its ``src``.  Run the commits in turns (A, B, B, A) in one call to the
card.

On phase ``fit``'s data (``make_dataset("d2", 2^17, seed=1)`` split
70/30) it records, by CUDA events and graph replay:

* kernel A as ``window_features(train, 3)`` launches it (all of its
  launches, replayed on their recorded arguments);
* the DSE fleet of phase ``fit`` (``SearchSpace()``, seed 0, trained by
  ``evaluate_batch``): each model's walk (``fleet_predict``'s hop
  launches, no trace) and each of its hops (walks of 1, 2, ... hops,
  differenced) beside its (S, k, T, L), at the test split and tiled to
  2^20 flows;
* ``Engine.run``'s walk (with its trace) of the ``(10, 10, 10)`` / k = 6
  model at the test split and at 2^20;
* the hop at ``Engine.run``'s main shape: phase ``times``' hop 1 of
  (3, 3, 3) / k = 4 at 2^20 from random SIDs, less the carry restore.

Where the checkout has ``engine_hop.WARP_MATCH_MIN_LEAVES``, the
crossover: models ``(d, d, d)`` for d = 3..6 at k = 4 and 6 (L = 8 to
64), each walked over the test split tiled to 2^20 with the trace (as
``Engine.run``) and without (as ``fleet_predict``), under the serial
and the warp match in turns (serial, warp, warp, serial), the two walks'
buffers equal.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CROSSOVER_DEPTHS = (3, 4, 5, 6)
CROSSOVER_KS = (4, 6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("dse_kernels_ab: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import fit
    from repro_torch.core import dse
    from repro_torch.core.inference import Engine, partition_walk
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.flows.synthetic import make_dataset
    from repro_torch.flows.windows import window_features, window_packets
    from repro_torch.kernels import engine_hop as eh
    from repro_torch.kernels import ops

    card = torch.device("cuda")
    t_start = time.perf_counter()
    out = {"tag": args.tag, "src": args.src, "card": cs.nvidia_smi()}
    ds = make_dataset("d2", cs.SERVE_FLOWS, seed=1)
    tr, te = ds.split()

    def walk(e, xx, with_trace=False, hops=None):
        return partition_walk(xx, e.tables.dev,
                              n_subtrees=e.tables.n_subtrees,
                              n_partitions=hops or e.tables.n_partitions,
                              with_trace=with_trace, hop=eh.engine_hop_kernel)

    def shape(e) -> dict:
        S_, k_, T_ = e.tables.dev.thresholds.shape
        return {"S": S_, "k": k_, "T": T_,
                "L": e.tables.dev.leaf_lo.shape[1]}

    # -- kernel A as window_features launches it --------------------------
    calls, real = [], ops.feature_window_kernel

    def record(*a):
        calls.append(a)
        return real(*a)

    ops.feature_window_kernel = record
    try:
        Xw_tr = window_features(tr, 3)
    finally:
        ops.feature_window_kernel = real
    launch_all = lambda: [real(*a) for a in calls]
    out["kernel_a_train_features"] = {
        "launches": len(calls), "ms": cs.cuda_ms(launch_all, reps=5),
        "graph_ms": cs.graph_ms(launch_all, 1, reps=3)}
    del calls

    # -- the DSE fleet ------------------------------------------------------
    space = dse.SearchSpace()
    P = space.max_partitions
    rng = np.random.default_rng(cs.FLEET_SEED)
    cfgs = []
    while len(cfgs) < cs.FLEET_BATCH:
        c = space.sample(rng)
        if c not in cfgs:
            cfgs.append(c)
    Xd_tr, Xd_te = window_features(tr, P), window_features(te, P)
    wp = window_packets(te, P)
    ev = dse.make_splidt_evaluator(Xd_tr, tr.labels, Xd_te, te.labels,
                                   n_classes=ds.n_classes,
                                   flows=cs.FLEET_FLOWS, trainer="torch",
                                   win_pkts_te=wp)
    scored, real_fleet = [], fit.batched.fleet_predict

    def fleet_seen(pdts_, *a, **kw):
        scored.append(list(pdts_))
        return real_fleet(pdts_, *a, **kw)

    fit.batched.fleet_predict = fleet_seen
    try:
        ev.evaluate_batch(cfgs)
    finally:
        fit.batched.fleet_predict = real_fleet
    engs = [Engine.from_model(p) for p in scored[0]]
    x = torch.from_numpy(wp).to(card)
    x_big = x.repeat(-(-cs.B_MAIN // x.shape[0]), 1, 1, 1)[:cs.B_MAIN]

    def fleet_scale(xx):
        rows = []
        for e in engs:
            cum = [cs.graph_ms(lambda: walk(e, xx, hops=h), 2, reps=3)
                   for h in range(1, e.tables.n_partitions + 1)]
            rows.append({**shape(e), "P": e.tables.n_partitions,
                         "graph_ms": cum[-1],
                         "hop_graph_ms": [b - a for a, b in
                                          zip([0.0] + cum[:-1], cum)]})
        fleet = lambda: [walk(e, xx) for e in engs]
        return {"B": xx.shape[0], "models": rows,
                "ms": cs.cuda_ms(fleet, reps=3),
                "graph_ms": cs.graph_ms(fleet, 2, reps=3)}

    out["fleet"] = {"test_split": fleet_scale(x),
                    "tiled_2^20": fleet_scale(x_big)}
    del x, x_big

    # -- Engine.run's walk of the (10, 10, 10) / k = 6 model ---------------
    x3 = torch.from_numpy(window_packets(te, 3)).to(card)
    x3_big = x3.repeat(-(-cs.B_MAIN // x3.shape[0]), 1, 1, 1)[:cs.B_MAIN]
    e_deep = Engine.from_model(train_partitioned_dt(
        Xw_tr, tr.labels, partition_sizes=[10, 10, 10], k=6,
        n_classes=ds.n_classes, trainer="torch"))
    deep = shape(e_deep)
    for tag, xx in (("test_split", x3), ("tiled_2^20", x3_big)):
        run = lambda: walk(e_deep, xx, with_trace=True)
        deep[tag] = {"B": xx.shape[0], "ms": cs.cuda_ms(run, reps=5),
                     "graph_ms": cs.graph_ms(run, 2, reps=3)}
    out["engine_run_deep"] = deep

    # -- the crossover of the two matches -------------------------------
    if hasattr(eh, "WARP_MATCH_MIN_LEAVES"):
        rows = []
        for k in CROSSOVER_KS:
            for d in CROSSOVER_DEPTHS:
                e = Engine.from_model(train_partitioned_dt(
                    Xw_tr, tr.labels, partition_sizes=[d] * 3, k=k,
                    n_classes=ds.n_classes, trainer="torch"))
                row = {**shape(e), "depth": d}
                for with_trace in (True, False):
                    fn = lambda: walk(e, x3_big, with_trace=with_trace)
                    got = {m: cs.under_match(m, fn)
                           for m in ("serial", "warp")}
                    cs.check(torch.equal(got["serial"], got["warp"]),
                             f"crossover d={d}, k={k}: serial == warp")
                    times = {"serial": [], "warp": []}
                    for m in ("serial", "warp", "warp", "serial"):
                        times[m].append(cs.under_match(
                            m, lambda: cs.graph_ms(fn, 2, reps=3)))
                    row["trace" if with_trace else "no_trace"] = times
                rows.append(row)
        out["crossover"] = {"B": cs.B_MAIN, "W": x3.shape[2],
                            "models": rows}
    del x3, x3_big

    # -- the hop at Engine.run's main shape ---------------------------------
    ds_m = make_dataset("d2", 6000)
    tr_m, te_m = ds_m.split()
    eng = Engine.from_model(train_partitioned_dt(
        window_features(tr_m, 3), tr_m.labels, partition_sizes=[3, 3, 3],
        k=4))
    wp_m = window_packets(te_m, 3)
    xm = torch.from_numpy(np.tile(wp_m, (-(-cs.B_MAIN // wp_m.shape[0]), 1,
                                         1, 1))[:cs.B_MAIN]).to(card)
    dev = eng.tables.dev
    S_m = dev.thresholds.shape[0]
    g = torch.Generator(device=card).manual_seed(0)
    torch.randint(0, S_m, (cs.B_MAIN,), generator=g, device=card)
    done0 = torch.rand(cs.B_MAIN, generator=g, device=card) < 0.3
    carry0 = (torch.randint(-1, S_m, (cs.B_MAIN,), generator=g, device=card,
                            dtype=torch.int32), done0,
              torch.where(done0, 0, -1).to(torch.int32),
              torch.zeros(cs.B_MAIN, dtype=torch.int32, device=card),
              torch.where(done0, 0, -1).to(torch.int32))
    work = tuple(t.clone() for t in carry0)
    regs = torch.empty(cs.B_MAIN, dev.slot_op.shape[1], device=card)

    def restore():
        for d, s in zip(work, carry0):
            d.copy_(s)

    def hop():
        eh.engine_hop_kernel(xm[:, 1], work, dev, 1,
                             n_subtrees=eng.tables.n_subtrees, regs_out=regs)

    out["main_hop"] = {
        **shape(eng),
        "graph_ms": (cs.graph_ms(lambda: (restore(), hop()), 20)
                     - cs.graph_ms(restore, 20)),
        "ms": cs.cuda_ms_after(restore, hop)}
    out["s"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
