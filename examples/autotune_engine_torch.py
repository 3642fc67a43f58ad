"""Autotune the port's engine for your model and batch shape, then
verify parity.

    PYTHONPATH=src python examples/autotune_engine_torch.py [--smoke]
    PYTHONPATH=src python examples/autotune_engine_torch.py --device cpu

Builds a synthetic SpliDT model, asks the router for its analytical
pick (``impl="auto"``, the cost model's row for the engine's device: no
timing), then runs the real tuner (``EngineOptions(impl="tuned")``):
candidate plans are shortlisted by the cost model, timed on the actual
windows, and the winner is cached per (shape, device fingerprint), so
re-running this script resolves the plan with a dict lookup.  Finally
the tuned route is checked with ``torch.equal`` against
``impl="fused"``, the plain walk: routing may change speed, never
verdicts (docs/PARITY.md).  The lines printed are those of
``examples/autotune_engine.py``, with the port's backends.

``--smoke`` shrinks everything and points the cache at a temporary file
(under ``TMPDIR``), so a smoke run does not touch ``~/.cache``.
``--device`` defaults to the card; without one it raises.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + temp cache")
    ap.add_argument("--flows", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core.inference import Engine, EngineOptions
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.device import resolve_device
    from repro_torch.flows.synthetic import make_dataset
    from repro_torch.flows.windows import window_features, window_packets
    from repro_torch.tuning import Plan, ShapeInfo, choose_plan, estimate_us
    from repro_torch.tuning.autotune import CACHE_ENV, cache_path
    from repro_torch.tuning.costmodel import BACKENDS, platform_of

    dev = resolve_device(args.device)
    if args.smoke:
        args.flows, args.batch = 400, 256
        os.environ[CACHE_ENV] = os.path.join(
            tempfile.mkdtemp(prefix="splidt-tune-"), "autotune.json")

    print("=== SpliDT engine autotuning ===")
    ds = make_dataset("d2", n_flows=args.flows)
    tr, te = ds.split()
    P, K = 3, 4
    Xw = window_features(tr, P, device=dev)
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[3, 3, 3], k=K)
    wp = window_packets(te, P)
    reps = -(-args.batch // wp.shape[0])
    wp = np.tile(wp, (reps, 1, 1, 1))[:args.batch]
    eng = Engine.from_model(pdt, device=dev)
    x = torch.from_numpy(wp).to(dev)

    shape = ShapeInfo.from_engine(eng, wp)
    platform = platform_of(dev)
    print(f"model: S={shape.S} subtrees over P={shape.P} partitions, "
          f"k={shape.k} registers; batch B={shape.B}, W={shape.W}")

    # 1. the analytical router (what EngineOptions(impl="auto") does on
    # every call), on the engine's device's row of the cost model
    print("\ncost-model estimates (us/batch):")
    estimates = {}
    for b in BACKENDS:
        if b == "cuda" and platform != "cuda":
            continue          # the hop kernel runs on a card only
        estimates[b] = estimate_us(shape, Plan(backend=b), platform=platform)
        print(f"  {b:>7}: {estimates[b]:>12.0f}")
    auto = choose_plan(shape, platform=platform)
    print(f"impl='auto' would pick: {auto.describe()}")

    # 2. the empirical tuner (impl="tuned"): cold call probes + caches
    tuned = EngineOptions(impl="tuned")
    t0 = time.perf_counter()
    res = eng.run(x, with_trace=False, options=tuned)
    cold_s = time.perf_counter() - t0
    print(f"\nimpl='tuned' cold call: {cold_s:.2f}s "
          f"-> plan: {res.plan.describe()}")
    t0 = time.perf_counter()
    res2 = eng.run(x, with_trace=False, options=tuned)
    print(f"impl='tuned' warm call: {time.perf_counter() - t0:.3f}s "
          f"(plan source: {res2.plan.source})")
    print(f"cache: {cache_path()}")

    # 3. parity: the tuned route must be bit-identical to the plain walk
    ref = eng.run(x, with_trace=False, options=EngineOptions(impl="fused"))
    for field in ("labels", "recircs", "exit_partition"):
        if not torch.equal(torch.from_numpy(getattr(res2, field)),
                           torch.from_numpy(getattr(ref, field))):
            raise AssertionError(f"impl='tuned' != impl='fused': {field}")
    print("parity vs impl='fused': bit-identical "
          f"({res2.labels.size} verdicts)")
    return {"device": str(dev), "estimates_us": estimates,
            "auto_plan": auto, "tuned_plan": res.plan,
            "warm_source": res2.plan.source, "cold_s": cold_s,
            "verdicts": int(res2.labels.size), "cache": cache_path()}


if __name__ == "__main__":
    main()
