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
   then ``profile``, one traced ``Engine.run``;
5. serve   -- live serving, the second path: ``make_dataset("d2", 2^17,
   seed=1)`` streamed by ``make_packet_stream(profile="steady",
   concurrency=65536)`` in ticks of 32,768 packets through
   ``FlowTableServer(eng, n_buckets=32768, bucket_size=8)`` (fused tick
   engine, ``impl=None``: the fold-and-finalize kernel and the range-match
   kernel), then ``flush()``.  One verdict per flow, each equal to
   ``Engine.run`` on the rebuilt windows and to ``pdt.predict``; packets/s,
   verdicts/s and per-tick host latency;
6. serve_check -- both fold kernels against their plain versions at the
   serving rank width and at a width that is no multiple of a block, and
   on a 4,096-flow prefix with a 512-slot table (spill) and a timeout,
   the ``cuda`` server against the ``fused`` server for both tick engines:
   every verdict in order and every stats field;
7. serve_times -- CUDA-event medians of both fold kernels and their plain
   versions beside their bounds, and one traced steady-state tick; then
   ``queued_bounds``, the bound of the TPU kernel still to port
   (``chunk_scan``) at the LM prototype's shape, computed, not run;
8. the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and last
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
SERVE_FLOWS = 1 << 17     # flows streamed through the live flow table
SERVE_CONCURRENCY = 65536  # mean concurrent flows of the steady stream
SERVE_TICK = 32768        # packets per ingest tick
SERVE_TABLE = (32768, 8)  # n_buckets, bucket_size: 2^18 slots
CHECK_FLOWS = 4096        # prefix served by both routes in serve_check
CHECK_TABLE = (64, 8)     # 512 slots: the prefix overflows into the spill
CHECK_CONCURRENCY = 2048.0
CHECK_TIMEOUT = 0.05      # stream seconds; evicts some idle flows (a
#                           shorter one evicts so many that none spill)
CHECK_TICK = 4096
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


def kernel_device_ms(fn, key: str, reps: int = 50) -> float:
    """Device time per call of the kernel whose profiler name contains
    ``key``, over ``reps`` traced calls of ``fn`` (which must launch no
    other kernel of that name): the launch overhead around it excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if key in e.key and str(e.device_type).endswith("CUDA"))
    check(total_us > 0, f"the profiler saw no {key} on the card")
    return total_us / reps / 1e3


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


def profile_run(fn, top: int = 12, warmup: bool = True,
                ranges: str | None = None) -> dict:
    """One traced call of ``fn`` (after an untraced one if ``warmup``):
    wall time, device busy time (the sum of kernel and copy time on the
    card) and the top device consumers; with ``ranges``, also the host
    and device time the trace attributes to each ``record_function``
    range whose name starts with it (the ``obs.span`` markers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them carry the same time again, and so do the
    # device-side spans of the ``ranges`` markers
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0
              and not (ranges and e.key.startswith(ranges))]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "top": [{"name": e.key[:80], "calls": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in events[:top]]}
    if ranges is not None:
        # each marker shows up twice: on the host (its wall time and the
        # device time of the kernels it launched) and on the device (the
        # span from its first kernel's start to its last one's end)
        rows = out["ranges"] = {}
        for e in prof.key_averages():
            if not e.key.startswith(ranges):
                continue
            r = rows.setdefault(e.key, {})
            if str(e.device_type).endswith("CUDA"):
                r["device_span_ms"] = e.device_time_total / 1e3
            else:
                r.update(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                         device_ms_launched=e.device_time_total / 1e3)
    return out


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


def chunk_scan_bound() -> dict:
    """The least time of the kernel still to port, ``chunk_scan_pallas``
    (src/repro/kernels/chunk_scan.py:92), at the shape the LM prototype
    gives it: rwkv6-1.6b's time-mix (32 heads of 64, chunk 128) at the
    ``train_4k`` shape (batch 256 x 4096 tokens), one layer, f32.  Bytes:
    q, k, decay (B*H, T, dk), v and o (B*H, T, dv), the bonus and the
    state in and out.  Operations: per chunk the two intra-chunk products
    (C x C x dk, C x C x dv) and the two state products (C x dk x dv
    each), 2 flops a multiply-add, in f32 outside the tensor cores (the
    port is to keep TF32 off)."""
    bh, t, dk, dv, c = 256 * 32, 4096, 64, 64, 128
    n_bytes = 4 * (bh * t * (3 * dk + 2 * dv) + bh * dk + 2 * bh * dk * dv)
    n_ops = bh * (t // c) * (2 * c * c * (dk + dv) + 2 * 2 * c * dk * dv)
    ms, by = bound_ms(n_bytes, n_ops)
    return {"shape": f"B*H={bh},T={t},dk={dk},dv={dv},C={c}",
            "bytes": n_bytes, "ops": n_ops, "bound_ms": ms, "bound_by": by,
            "ms": "not measured"}


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
    from repro_torch.flows.synthetic import (
        FlowDataset, make_dataset, make_packet_stream,
    )
    from repro_torch.flows.windows import (
        _all_feature_rows, window_features, window_packets,
    )
    from repro_torch.kernels import _build, dispatch, dt_traverse, ref
    from repro_torch.kernels import feature_window as fw
    from repro_torch.obs import reset_spans, span_totals
    from repro_torch.serve import FlowTableServer, StreamVerdicts

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

    def compare(name, got, want, log=None):
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        # equal elements count 0, so matching infinities do not give NaN
        diff = torch.where(got == want, 0.0,
                           (got.double() - want.double()).abs())
        err = float(diff.max()) if got.numel() else 0.0
        (checks if log is None else log)[name] = {"equal": equal,
                                                  "max_abs_err": err}
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

    # -- 5. live serving through the flow table ------------------------------
    t0 = time.perf_counter()
    ds_s = make_dataset("d2", SERVE_FLOWS, seed=1)
    stream = make_packet_stream(ds_s, seed=7, profile="steady",
                                concurrency=SERVE_CONCURRENCY)
    serve_setup_s = time.perf_counter() - t0
    srv = FlowTableServer(eng, n_buckets=SERVE_TABLE[0],
                          bucket_size=SERVE_TABLE[1])
    check(srv._cuda and srv.tick_engine == "fused",
          "the default server runs the kernels in the fused tick engine")
    ticks = list(stream.ticks(SERVE_TICK))
    profiled = len(ticks) // 2          # a steady-state tick, traced
    calls, tick_s, tick_dispatches, shapes = [], [], [], []
    torch.cuda.synchronize()
    fw.launches = fw.update_launches = fw.update_finalize_launches = 0
    dt_traverse.launches = 0
    reset_spans()
    for i, batch in enumerate(ticks):
        d0 = srv.stats.dispatches
        if i == profiled:
            # host spans count the untraced calls only
            spans_before = span_totals()
            tick_prof = profile_run(lambda: calls.append(srv.ingest(batch)),
                                    warmup=False, ranges="tick/")
            reset_spans()
        else:
            t0 = time.perf_counter()
            calls.append(srv.ingest(batch))
            tick_s.append(time.perf_counter() - t0)
        tick_dispatches.append(srv.stats.dispatches - d0)
        shapes.append(srv.last_tick_shape)
    t0 = time.perf_counter()
    calls.append(srv.flush())
    flush_s = time.perf_counter() - t0
    host_spans = span_totals()
    for path, t in spans_before.items():
        merged = host_spans.setdefault(path, {"calls": 0, "s": 0.0})
        merged["calls"] += t["calls"]
        merged["s"] += t["s"]
    serve_launches = {"feature_update_finalize": fw.update_finalize_launches,
                      "dt_traverse": dt_traverse.launches,
                      "feature_update": fw.update_launches,
                      "feature_window": fw.launches}
    check(serve_launches["feature_update_finalize"] > 0
          and serve_launches["dt_traverse"] > 0,
          f"serving launched kernels 4 and 2, got {serve_launches}")
    check(serve_launches["feature_update"] == 0,
          "the fused tick engine runs no bare fold")
    v = StreamVerdicts.concat(calls)
    check(v.n_flows == SERVE_FLOWS
          and np.unique(v.flow_id).size == SERVE_FLOWS,
          "one verdict per served flow")
    order = np.argsort(v.flow_id)
    full = eng.run(window_packets(ds_s, 3), with_trace=False)  # cuda walk
    want = pdt.predict(window_features(ds_s, 3), return_trace=True)
    for name, oracle in zip(("labels", "recircs", "exit_partition"), want):
        got = getattr(v, name)[order]
        check(got.dtype == np.int32, f"serve {name} dtype")
        check(np.array_equal(got, getattr(full, name)),
              f"serve {name} == Engine.run on the rebuilt windows")
        check(np.array_equal(got, oracle), f"serve {name} == pdt.predict")
    wall_s = sum(tick_s) + flush_s      # every call but the traced tick
    prof_pkts = ticks[profiled].n_packets
    prof_verdicts = calls[profiled].n_flows
    shape_counts = {}
    for r, c in shapes:
        shape_counts[f"{r}x{c}"] = shape_counts.get(f"{r}x{c}", 0) + 1
    C_serve = max(shape_counts.items(), key=lambda kv: kv[1])[0]
    C_serve = int(C_serve.split("x")[1])
    state_bytes = sum(t.numel() * t.element_size() for t in srv._tstate)
    emit("serve", card=smi, n_flows=SERVE_FLOWS, n_packets=stream.n_packets,
         n_ticks=len(ticks), tick_packets=SERVE_TICK,
         concurrency=SERVE_CONCURRENCY, table_slots=srv.table.capacity,
         tick_state_bytes_per_slot=state_bytes / (srv.table.capacity + 1),
         setup_s=serve_setup_s, wall_s_untraced=wall_s,
         packets_per_s=(stream.n_packets - prof_pkts) / wall_s,
         verdicts_per_s=(v.n_flows - prof_verdicts) / wall_s,
         tick_ms_p50=float(np.percentile(tick_s, 50)) * 1e3,
         tick_ms_p99=float(np.percentile(tick_s, 99)) * 1e3,
         tick_ms_max=max(tick_s) * 1e3, flush_ms=flush_s * 1e3,
         dispatches_per_tick=float(np.mean(tick_dispatches)),
         dispatches_per_tick_max=max(tick_dispatches),
         launches=serve_launches,
         launches_per_tick={k: n / len(ticks)
                            for k, n in serve_launches.items()},
         rank_x_width_per_tick=shape_counts, host_spans_s=host_spans,
         stats=srv.stats.as_dict(),
         serve_recirc_overhead=srv.registry.gauge(
             "serve_recirc_overhead").value,
         n_unterminated=v.n_unterminated,
         verdicts_equal_engine_run_and_predict=True)

    # -- 6. fold kernels and the cuda server vs their plain versions --------
    serve_checks = {}
    st = srv._tstate

    def fold_args(C):
        """Packets of the stream and real resident state rows, with the
        slot rows of each row's SID: the fold's inputs at width C."""
        rows = torch.arange(C, device=card) % srv.table.capacity
        sid = st.sid[rows].long()
        pkt = torch.from_numpy(stream.pkts[:C]).to(card)
        return (pkt, *(t[sid] for t in dev[:4]), st.acc[rows].contiguous(),
                st.seen[rows].contiguous())

    err3 = err4 = 0.0
    C_odd = C_serve - 37                # no multiple of any block size
    for C in (C_serve, C_odd):
        pkt, op, fld, prd, init, acc, seen = fold_args(C)
        for i, (got, want_) in enumerate(zip(
                fw.feature_update_kernel(pkt, op, fld, prd, acc, seen),
                ref.feature_update_ref(pkt, op, fld, prd, acc, seen))):
            err3 = max(err3, compare(f"feature_update[C={C},k={k}][{i}]",
                                     got, want_, serve_checks))
        for i, (got, want_) in enumerate(zip(
                fw.feature_update_finalize_kernel(pkt, op, fld, prd, init,
                                                  acc, seen),
                ref.feature_update_finalize_ref(pkt, op, fld, prd, init, acc,
                                                seen))):
            err4 = max(err4, compare(
                f"feature_update_finalize[C={C},k={k}][{i}]", got, want_,
                serve_checks))

    sub = slice(0, CHECK_FLOWS)
    ds_p = FlowDataset(ds_s.packets[sub], ds_s.lengths[sub],
                       ds_s.labels[sub], ds_s.n_classes, ds_s.name)
    stream_p = make_packet_stream(ds_p, seed=7, profile="steady",
                                  concurrency=CHECK_CONCURRENCY)
    route_runs = {}
    for tick_engine in ("fused", "legacy"):
        runs = {}
        for impl in ("cuda", "fused"):
            fw.update_launches = fw.update_finalize_launches = 0
            srv_c = FlowTableServer(
                eng, n_buckets=CHECK_TABLE[0], bucket_size=CHECK_TABLE[1],
                timeout=CHECK_TIMEOUT, tick_engine=tick_engine,
                options=EngineOptions(impl=impl))
            t0 = time.perf_counter()
            got_calls = ([srv_c.ingest(b) for b in stream_p.ticks(CHECK_TICK)]
                         + [srv_c.flush()])
            runs[impl] = (got_calls, srv_c.stats.as_dict(), {
                "feature_update": fw.update_launches,
                "feature_update_finalize": fw.update_finalize_launches},
                time.perf_counter() - t0)
        (a_calls, a_stats, a_l, a_s), (b_calls, b_stats, b_l, b_s) = (
            runs["cuda"], runs["fused"])
        check(len(a_calls) == len(b_calls), "same number of calls")
        for j, (a, b) in enumerate(zip(a_calls, b_calls)):
            for name in ("flow_id", "labels", "recircs", "exit_partition"):
                check(np.array_equal(getattr(a, name), getattr(b, name)),
                      f"{tick_engine} server cuda == fused: call {j} {name}")
        check(a_stats == b_stats, f"{tick_engine} server stats cuda == fused")
        check(a_stats["spilled"] > 0 and a_stats["evicted"] > 0,
              f"the check run spills and evicts: {a_stats}")
        check(b_l == {"feature_update": 0, "feature_update_finalize": 0},
              "the fused route launches no fold kernel")
        used = ("feature_update" if tick_engine == "legacy"
                else "feature_update_finalize")
        check(a_l[used] > 0, f"{tick_engine} cuda server launched {used}")
        route_runs[tick_engine] = {
            "stats": a_stats, "cuda_launches": a_l,
            "cuda_launches_per_tick": {k: n / a_stats["ticks"]
                                       for k, n in a_l.items()},
            "cuda_s": a_s, "fused_s": b_s, "verdicts_equal": True,
            "stats_equal": True}
    emit("serve_check", tolerance="zero: torch.equal and np.array_equal",
         comparisons=serve_checks, prefix_flows=CHECK_FLOWS,
         table_slots=CHECK_TABLE[0] * CHECK_TABLE[1],
         timeout_s=CHECK_TIMEOUT, servers=route_runs)

    # -- 7. fold kernel times at the serving width ---------------------------
    pkt, op, fld, prd, init, acc, seen = fold_args(C_serve)
    # a call of either wrapper costs more host time than its kernel costs
    # device time, so CUDA events around one call (call_ms) measure the
    # launch; the kernel's own time (ms) comes from the profiler
    fold3 = lambda: fw.feature_update_kernel(pkt, op, fld, prd, acc, seen)
    fold4 = lambda: fw.feature_update_finalize_kernel(pkt, op, fld, prd,
                                                      init, acc, seen)
    call3 = cuda_ms(fold3, reps=50, warmup=5)
    call4 = cuda_ms(fold4, reps=50, warmup=5)
    ms3 = kernel_device_ms(fold3, "feature_update_kernel")
    ms4 = kernel_device_ms(fold4, "feature_update_kernel")
    plain3 = cuda_ms(lambda: ref.feature_update_ref(pkt, op, fld, prd, acc,
                                                    seen), reps=50, warmup=5)
    plain4 = cuda_ms(lambda: ref.feature_update_finalize_ref(
        pkt, op, fld, prd, init, acc, seen), reps=50, warmup=5)
    # least traffic: the packet row and 5 (n, k) inputs in, 2 out; the
    # finalize form reads init and writes regs too.  About 4 f32
    # operations a slot.
    n_slot = C_serve * k
    bytes3 = C_serve * 6 * 4 + n_slot * 4 * 5 + n_slot * 4 * 2
    bytes4 = bytes3 + n_slot * 4 * 2
    bound3, by3 = bound_ms(bytes3, 4 * n_slot)
    bound4, by4 = bound_ms(bytes4, 5 * n_slot)
    legacy_ticks = route_runs["legacy"]["stats"]["ticks"]
    emit("serve_times", card=smi, C=C_serve, k=k,
         feature_update_ms=ms3, feature_update_call_ms=call3,
         feature_update_plain_ms=plain3,
         feature_update_bound_ms=bound3, feature_update_bytes=bytes3,
         feature_update_launches_per_legacy_tick=(
             route_runs["legacy"]["cuda_launches"]["feature_update"]
             / legacy_ticks),
         feature_update_finalize_ms=ms4,
         feature_update_finalize_call_ms=call4,
         feature_update_finalize_plain_ms=plain4,
         feature_update_finalize_bound_ms=bound4,
         feature_update_finalize_bytes=bytes4,
         feature_update_finalize_launches_per_tick=(
             serve_launches["feature_update_finalize"] / len(ticks)),
         steady_state_tick=dict(index=profiled,
                                packets=prof_pkts, **tick_prof))
    emit("queued_bounds", chunk_scan=chunk_scan_bound())

    # -- 8. summary -----------------------------------------------------------
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
        {"name": "feature_update", "route": "cuda",
         "source": "src/repro_torch/csrc/feature_update.cu",
         "replaces": "src/repro/kernels/feature_window.py:193",
         "launches": route_runs["legacy"]["cuda_launches"]["feature_update"],
         "launches_path": "serve_check: the legacy tick engine, cuda route",
         "max_abs_err": err3, "ms": ms3, "call_ms": call3,
         "plain_ms": plain3,
         "bound_ms": bound3, "bound_by": by3, "library_ms": None,
         "shape": f"C={C_serve},k={k}", "equal": True},
        {"name": "feature_update_finalize", "route": "cuda",
         "source": "src/repro_torch/csrc/feature_update.cu",
         "replaces": "src/repro/kernels/feature_window.py:276",
         "launches": serve_launches["feature_update_finalize"],
         "launches_path": "serve: the fused tick engine",
         "max_abs_err": err4, "ms": ms4, "call_ms": call4,
         "plain_ms": plain4,
         "bound_ms": bound4, "bound_by": by4, "library_ms": None,
         "shape": f"C={C_serve},k={k}", "equal": True},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
