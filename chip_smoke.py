#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failed check raises, so the script
exits nonzero; nothing is caught and passed over):

1. device  -- ``nvidia-smi`` name and power limit, and the time to build
   both CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
2. main    -- ``make_dataset("d2", 6000)`` -> ``window_features`` (kernel A)
   -> ``train_partitioned_dt([3, 3, 3], k=4)`` -> ``window_packets`` of the
   test split tiled to 2^20 flows -> ``Engine.from_model(pdt).run`` on the
   card (kernels A and B).  Verdicts must equal ``np.tile`` of the numpy
   oracle ``pdt.predict`` on the untiled test windows, and both kernels
   must have launched (launch counts zeroed just before, read just after);
3. check   -- each kernel against its plain PyTorch version on the card at
   the main path's shapes, and the engine's ``cuda`` walk against its
   ``fused`` walk, all with ``torch.equal`` (zero tolerance);
4. times   -- CUDA-event medians of each kernel and its plain version beside
   the least time the card could take (bytes over 3.35 TB/s), and
   ``Engine.run`` flows/s from numpy and from a device-resident tensor;
5. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  Exits nonzero when there is
no CUDA card or when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

B_MAIN = 1 << 20          # engine batch: flows per Engine.run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_s(fn, reps: int) -> float:
    """Median host-clock seconds of ``fn`` (which ends in a host fetch)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_run(fn, top: int = 12) -> dict:
    """One traced call of ``fn``: wall time, device busy time (the sum of
    kernel and copy time on the card) and the top device consumers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in events[:top]]}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core.inference import Engine, EngineOptions
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.core.tree import macro_f1
    from repro_torch.flows.synthetic import make_dataset
    from repro_torch.flows.windows import (
        _all_feature_rows, window_features, window_packets,
    )
    from repro_torch.kernels import _build, dispatch, dt_traverse, ref
    from repro_torch.kernels import feature_window as fw

    card = torch.device("cuda")
    smi = nvidia_smi()

    # -- 1. device and build ------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    for src in _build.SOURCES:
        _build.load(src)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for src in _build.SOURCES
             for ln in (out_dir / f"{pathlib.Path(src).stem}.log")
             .read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s, ptxas=ptxas)

    # -- 2. the main path, through the public entry points ------------------
    fw.launches = dt_traverse.launches = 0
    t0 = time.perf_counter()
    ds = make_dataset("d2", 6000)
    tr, te = ds.split()
    Xw = window_features(tr, 3)                         # kernel A, k = 41
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[3, 3, 3],
                               k=4)
    wp_te = window_packets(te, 3)
    reps = -(-B_MAIN // wp_te.shape[0])
    wp = np.tile(wp_te, (reps, 1, 1, 1))[:B_MAIN]
    setup_s = time.perf_counter() - t0
    eng = Engine.from_model(pdt)
    fw_setup = fw.launches
    t0 = time.perf_counter()
    res = eng.run(wp)                                   # kernels A and B
    run_s = time.perf_counter() - t0
    launches = {"feature_window": fw.launches,
                "dt_traverse": dt_traverse.launches}
    run_launches = {"feature_window": fw.launches - fw_setup,
                    "dt_traverse": dt_traverse.launches}
    S, k, T = eng.tables.dev.thresholds.shape
    L = eng.tables.dev.leaf_lo.shape[1]
    P, W = wp.shape[1], wp.shape[2]
    # the oracle sees features from the plain version, not from kernel A
    labels, recircs, exit_p = pdt.predict(window_features(te, 3,
                                                          device="cpu"),
                                          return_trace=True)
    tile = lambda a: np.tile(a, reps)[:B_MAIN]
    for name, want in (("labels", labels), ("recircs", recircs),
                       ("exit_partition", exit_p)):
        got = getattr(res, name)
        check(got.shape == (B_MAIN,) and got.dtype == np.int32, name)
        check(np.array_equal(got, tile(want)), f"{name} == numpy oracle")
    check(len(res.regs_trace) == P and all(
        r.shape == (B_MAIN, k) and np.isfinite(r).all()
        for r in res.regs_trace), "register trace shape and finiteness")
    check(run_launches["feature_window"] == P
          and run_launches["dt_traverse"] == P,
          f"one launch of each kernel per hop, got {run_launches}")
    f1 = macro_f1(tile(te.labels), res.labels, ds.n_classes)
    emit("main", n_train=tr.n_flows, n_test=te.n_flows, B=B_MAIN, P=P, W=W,
         S=S, k=k, T=T, L=L, launches=launches,
         engine_run_launches=run_launches, macro_f1=f1,
         mean_recircs=float(res.recircs.mean()),
         n_unterminated=res.n_unterminated, setup_s=setup_s,
         first_run_s=run_s, verdicts_equal_oracle=True)

    # -- 3. kernels vs plain versions on the card, main-path shapes ---------
    x = torch.from_numpy(wp).to(card)                   # (B, P, W, 6)
    g = torch.Generator(device=card).manual_seed(0)
    sid = torch.randint(0, S, (B_MAIN,), generator=g, device=card,
                        dtype=torch.int32)
    dev = eng.tables.dev
    rows = [t[sid.long()] for t in dev[:4]]
    checks = {}

    def compare(name, got, want):
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        checks[name] = {"equal": equal, "max_abs_err": err}
        check(equal, f"{name}: kernel == plain version")
        return err

    a_args = (x[:, 1], *rows)                           # a strided hop view
    err_a = compare("feature_window[B=2^20,W=65,k=4]",
                    fw.feature_window_kernel(*a_args),
                    ref.feature_window_ref(*a_args))
    xtr = torch.from_numpy(window_packets(tr, 3)).to(card)
    a41_args = (xtr[:, 2], *_all_feature_rows(tr.n_flows, card))
    err_a = max(err_a, compare(
        f"feature_window[B={tr.n_flows},W={xtr.shape[2]},k=41]",
        fw.feature_window_kernel(*a41_args),
        ref.feature_window_ref(*a41_args)))

    regs = fw.feature_window_kernel(*a_args)
    bb = 128
    d = dispatch.sid_dispatch(sid, n_subtrees=S, block_b=bb)
    regs_g = regs.new_zeros((d.block_sid.shape[0] * bb, k))
    regs_g[d.dest.long()] = regs[d.order.long()]
    b_args = (d.block_sid, regs_g, *dev[4:])
    err_b = compare("dt_traverse[blocks]",
                    dt_traverse.dt_traverse_kernel(*b_args, block_b=bb),
                    dt_traverse.dt_traverse_blocks_ref(*b_args, block_b=bb))
    s = sid.long()
    err_b = max(err_b, compare(
        f"dt_traverse[dispatch,S={S},k={k},T={T},L={L},bb={bb}]",
        dispatch.dispatch_dt_traverse(regs, sid, *dev[4:], block_b=bb),
        ref.dt_traverse_ref(regs, dev.thresholds[s], dev.leaf_lo[s],
                            dev.leaf_hi[s], dev.leaf_action[s],
                            dev.leaf_valid[s] > 0)))

    fused = eng.run(x, options=EngineOptions(impl="fused"))
    cuda = eng.run(x, options=EngineOptions(impl="cuda"))
    for name in ("labels", "recircs", "exit_partition"):
        check(np.array_equal(getattr(cuda, name), getattr(fused, name)),
              f"engine cuda == fused: {name}")
    for p, (a, b) in enumerate(zip(cuda.regs_trace, fused.regs_trace)):
        check(np.array_equal(a, b), f"engine cuda == fused: regs hop {p}")
    checks["engine[cuda==fused,B=2^20]"] = {"equal": True,
                                             "max_abs_err": 0.0}
    emit("check", tolerance="zero: torch.equal", comparisons=checks)

    # -- 4. times -------------------------------------------------------------
    ms_a = cuda_ms(lambda: fw.feature_window_kernel(*a_args))
    plain_a = cuda_ms(lambda: ref.feature_window_ref(*a_args))
    ms_a41 = cuda_ms(lambda: fw.feature_window_kernel(*a41_args))
    plain_a41 = cuda_ms(lambda: ref.feature_window_ref(*a41_args))
    ms_b = cuda_ms(lambda: dt_traverse.dt_traverse_kernel(*b_args,
                                                          block_b=bb))
    plain_b = cuda_ms(lambda: dt_traverse.dt_traverse_blocks_ref(
        *b_args, block_b=bb))
    ms_dispatch = cuda_ms(lambda: dispatch.dispatch_dt_traverse(
        regs, sid, *dev[4:], block_b=bb))

    # least traffic: every input read once, every output written once
    def fw_bound(n, w, kk):
        n_bytes = n * w * 6 * 4 + n * kk * 4 * 4 + n * kk * 4
        n_ops = n * kk * w * 6            # 3 f32 mul + 3 f32 add per packet
        return bound_ms(n_bytes, n_ops)

    bound_a, by_a = fw_bound(B_MAIN, W, k)
    bound_a41, _ = fw_bound(tr.n_flows, xtr.shape[2], 41)
    nb = d.block_sid.shape[0]
    b_bytes = (nb * 4 + nb * bb * k * 4 + nb * bb * 4
               + sum(t.numel() * 4 for t in dev[4:]))
    bound_b, by_b = bound_ms(b_bytes, nb * bb * (k * T + 2 * L * k))

    # the run's own peak: what it allocates above the tensors held here
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_np_s = host_s(lambda: eng.run(wp), reps=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    run_dev_s = host_s(lambda: eng.run(x), reps=10)
    run_dev_notrace_s = host_s(lambda: eng.run(x, with_trace=False),
                               reps=10)
    run_fused_s = host_s(lambda: eng.run(
        x, options=EngineOptions(impl="fused")), reps=3)
    emit("times", card=smi,
         feature_window_ms=ms_a, feature_window_plain_ms=plain_a,
         feature_window_bound_ms=bound_a,
         feature_window_k41_ms=ms_a41, feature_window_k41_plain_ms=plain_a41,
         feature_window_k41_bound_ms=bound_a41,
         dt_traverse_ms=ms_b, dt_traverse_plain_ms=plain_b,
         dt_traverse_bound_ms=bound_b, dispatch_dt_traverse_ms=ms_dispatch,
         engine_run_from_numpy_s=run_np_s,
         engine_flows_per_s_from_numpy=B_MAIN / run_np_s,
         engine_run_from_device_s=run_dev_s,
         engine_flows_per_s_from_device=B_MAIN / run_dev_s,
         engine_run_from_device_no_trace_s=run_dev_notrace_s,
         engine_fused_from_device_s=run_fused_s,
         engine_fused_flows_per_s_from_device=B_MAIN / run_fused_s,
         peak_memory_allocated_gb=peak_gb,
         engine_run_from_numpy_peak_above_held_gb=run_peak_gb)
    emit("profile", card=smi, **profile_run(lambda: eng.run(x)))

    # -- 5. summary -----------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "feature_window", "route": "cuda",
         "source": "src/repro_torch/csrc/feature_window.cu",
         "replaces": "src/repro/kernels/feature_window.py:115",
         "launches": launches["feature_window"], "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a,
         "bound_by": by_a, "library_ms": None,
         "shape": f"B={B_MAIN},W={W},k={k}", "equal": True},
        {"name": "dt_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/dt_traverse.cu",
         "replaces": "src/repro/kernels/dt_traverse.py:58",
         "launches": launches["dt_traverse"], "max_abs_err": err_b,
         "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b,
         "bound_by": by_b, "library_ms": None,
         "shape": f"nb={nb},bb={bb},S={S},k={k},T={T},L={L}",
         "equal": True},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
