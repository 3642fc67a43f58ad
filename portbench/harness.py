"""One run of one cell: set-up, the measured window, the reference and
the result.

Set-up trains or loads the configuration's model, draws the traffic
mix's pool of distinct flows from the seed, cuts their windows, builds
the port's engine, uploads the pool once and gathers the ring of
batches on the device (each batch every pool flow ``B / n`` times, in a
seeded order), then warms up.  The window is a closed loop: one
``Engine.run`` in flight, each call given the next batch of the ring
and returning its verdicts in host memory.  A traced run has two
windows of steady calls instead: the program's spans on with no
profiler, then the profiler.  A seeded reservoir keeps
the verdicts of ``SAMPLE_CALLS`` calls, which the reference judges once
the window has closed and the batches are freed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import check, model as model_lib, peaks, program
from . import trace as trace_lib
from .cells import Cell, reader
from .ref import flows, walk as walk_lib, windows, work as work_lib

#: calls whose verdicts the reference judges, drawn from the whole window
SAMPLE_CALLS = 8
#: steady calls in a traced run's span window, and again under the profiler
TRACE_CALLS = 200


@dataclasses.dataclass
class Setup:
    model: object
    trained: bool
    pool: flows.FlowSet
    pool_windows: np.ndarray
    engine: object
    options: object
    batches: list
    rows: list[np.ndarray]
    steps_s: dict

    @property
    def batch_flows(self) -> int:
        return int(self.rows[0].size)

    def call(self, i: int):
        return self.engine.run(self.batches[i % len(self.batches)],
                               with_trace=False, options=self.options)


def seeds(seed: int) -> tuple[np.random.Generator, ...]:
    """Independent generators for the pool, the batches' order and the
    sample of calls."""
    ss = np.random.SeedSequence(seed % (1 << 64))
    return tuple(np.random.default_rng(s) for s in ss.spawn(3))


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes on the host: the model, the pool, its
    windows and each batch's pool rows."""
    model: object
    trained: bool
    pool: flows.FlowSet
    pool_windows: np.ndarray
    rows: list[np.ndarray]


def inputs(cell: Cell, traffic: dict, pool_rng, batch_rng) -> Inputs:
    config = cell.config
    model, trained = model_lib.load_or_train(config)
    n, B = int(traffic["pool_flows"]), int(traffic["batch_flows"])
    if B % n:
        raise ValueError(f"batch_flows {B} is no multiple of pool_flows {n}")
    pool = flows.make_pool(config["dataset"], traffic["class_weights"], n,
                           pool_rng)
    pool_windows = windows.window_packets(
        pool.packets, pool.lengths, model_lib.n_windows(config),
        model_lib.window_width(config))
    rows = [batch_rng.permutation(np.tile(np.arange(n), B // n))
            for _ in range(int(traffic["batches"]))]
    return Inputs(model, trained, pool, pool_windows, rows)


def prepare(cell: Cell, traffic: dict, pool_rng, batch_rng,
            device) -> Setup:
    import torch
    t0 = time.perf_counter()
    x = inputs(cell, traffic, pool_rng, batch_rng)
    t1 = time.perf_counter()
    eng = program.engine(x.model, device)
    opts = program.options(traffic)
    t2 = time.perf_counter()
    pool_dev = torch.from_numpy(x.pool_windows).to(device)
    batches = [pool_dev.index_select(0, torch.from_numpy(r).to(device))
               for r in x.rows]
    del pool_dev
    _sync(device)
    steps = {"inputs": t1 - t0, "engine": t2 - t1,
             "batches": time.perf_counter() - t2}
    return Setup(x.model, x.trained, x.pool, x.pool_windows, eng, opts,
                 batches, x.rows, steps)


def warm_up(s: Setup, device) -> None:
    """Every shape the window uses, built and run; the host's pinned
    blocks for the sampled calls' verdicts allocated once (held together,
    then released to the caching allocator)."""
    held = [s.call(i) for i in range(SAMPLE_CALLS + 2)]
    del held
    _sync(device)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``size`` calls of a stream of unknown length,
    drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = size, rng, 0
        self.kept: dict[int, check.Kept] = {}

    def offer(self, call: int, batch: int, res) -> None:
        slot = (self.seen if self.seen < self.size
                else int(self.rng.integers(0, self.seen + 1)))
        self.seen += 1
        if slot < self.size:
            self.kept[slot] = check.Kept(call, batch, res.labels,
                                         res.recircs, res.exit_partition)

    def sample(self) -> list[check.Kept]:
        return [self.kept[i] for i in sorted(self.kept)]


def timed_window(s: Setup, seconds: float, res: Reservoir) -> dict:
    """The closed loop; each call's latency on the host's clock, from the
    call to ``Engine.run`` to its return with the verdicts on the host."""
    nb = len(s.batches)
    lat = []
    i = 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = s.call(i)
        lat.append(time.perf_counter() - t)
        res.offer(i, i % nb, out)
        del out
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    lat_ms = 1e3 * np.asarray(lat)
    return {"calls": i, "window_s": window_s,
            "flows_per_s": i * s.batch_flows / window_s,
            "batch_p95_ms": float(np.percentile(lat_ms, 95)),
            "batch_p50_ms": float(np.percentile(lat_ms, 50))}


def span_window(s: Setup, res: Reservoir, calls: int) -> dict:
    """``calls`` steady calls with the program's spans on and no
    profiler: the spans' totals, which no profiler overhead inflates."""
    nb = len(s.batches)
    program.set_spans(True)
    for i in range(calls):
        res.offer(i, i % nb, s.call(i))
    spans = program.span_totals()
    program.set_spans(False)
    return spans


def traced_window(s: Setup, res: Reservoir, calls: int, first: int):
    """``calls`` steady calls under the profiler, from call ``first``;
    the spans stay on so that the breakdown names the host's gaps by
    them."""
    nb = len(s.batches)
    program.set_spans(True)

    def one(i):
        res.offer(first + i, (first + i) % nb, s.call(first + i))

    tr = trace_lib.record(one, calls)
    program.set_spans(False)
    return tr


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    trace: trace_lib.Trace
    spans: dict                 # the span window's totals
    calls: int                  # calls under the profiler
    least_s: float | None       # least time of one batch's work


def run(cell: Cell, *, seed: int, seconds: float, traced: bool, device,
        t_start: float, traffic: dict | None = None,
        trace_calls: int = TRACE_CALLS) -> tuple[dict, dict]:
    """One run: ``(result, info)``, the result line's object (``check``
    last) and what else the run learned (calls, survivors, set-up steps,
    the work count).  ``traffic`` overrides the cell's mix (the CPU tests
    shrink it)."""
    import torch
    traffic = cell.traffic if traffic is None else traffic
    pool_rng, batch_rng, sample_rng = seeds(seed)
    t_run = time.perf_counter()
    program.set_spans(False)
    s = prepare(cell, traffic, pool_rng, batch_rng, device)
    t_warm = time.perf_counter()
    warm_up(s, device)
    setup_s = time.perf_counter() - t_start
    s.steps_s = {"imports": t_run - t_start, **s.steps_s,
                 "warm_up": t_start + setup_s - t_warm}

    res = Reservoir(SAMPLE_CALLS, sample_rng)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if traced:
        spans = span_window(s, res, trace_calls)
        tr = traced_window(s, res, trace_calls, first=trace_calls)
        calls = 2 * trace_calls
    else:
        window = timed_window(s, seconds, res)
        calls = window["calls"]
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    s.batches.clear()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = walk_lib.walk(s.model, windows.all_features(
        s.pool_windows, fids=s.model.used_features()))
    numbers = check.compare(res.sample(), ref, s.rows)
    ref_s = time.perf_counter() - t_ref

    B = s.batch_flows
    survivors = [int(np.count_nonzero((ref.exit_p[s.rows[0]] < 0)
                                      | (ref.exit_p[s.rows[0]] >= p)))
                 for p in range(s.model.n_partitions)]
    info = {"calls": calls, "batch_flows": B, "batches": len(s.rows),
            "survivors_entering_hop": survivors,
            "model_trained_here": s.trained, "setup_steps_s": s.steps_s,
            "reference_s": ref_s}
    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": check.passes(numbers), "attempted": calls * B,
           "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        pk = peaks.PEAKS.get(kind)
        least = None
        if pk is not None:
            w = work_lib.batch_work(s.model, s.pool.lengths, ref, s.rows[0])
            least, by = w.least_s(pk["bytes_per_s"], pk["f32_ops_per_s"])
            info.update(work_bytes=w.bytes, work_ops=w.ops,
                        least_ms=least * 1e3, bound_by=by)
        ctx = Context(tr, spans, trace_calls, least)
        for m in cell.per_layer:
            v = reader(m.name)(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        busy, _ = tr.busy_and_gaps()
        dev.update(busy_s=busy, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    else:
        e2e = {"flows_per_s": window["flows_per_s"],
               "batch_p95_ms": window["batch_p95_ms"], "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": e2e[m.name], "unit": m.unit}
        info.update(window_s=window["window_s"],
                    batch_p50_ms=window["batch_p50_ms"])
    out["check"] = numbers
    return out, info
