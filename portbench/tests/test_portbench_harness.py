"""The harness on the CPU: names resolve, the work count, the result
line, the imports, the faults that must make ``correct`` false and the
bf16 control; one card test."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import cells, check, control, harness, imports
from portbench import model as model_lib
from portbench import trace as trace_lib
from portbench.ref import trainer, walk, work

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PORTBENCH = cells.BENCH
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "breakdown", "check"}


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(model_lib, "CACHE", tmp_path)
    return tmp_path


def small_cell(name: str, n_train: int = 1500, pool: int = 256,
               batch: int = 1024):
    cell = cells.resolve(name)
    config = dict(cell.config,
                  dataset=dict(cell.config["dataset"], n_flows=n_train))
    return dataclasses.replace(cell, config=config, traffic=dict(
        cell.traffic, pool_flows=pool, batch_flows=batch, batches=2))


def cpu_run(cell, seed=2**31 + 3, seconds=0.3):
    return harness.run(cell, seed=seed, seconds=seconds, traced=False,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter())


# --- names -----------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_resolves_by_name(name):
    cell = cells.resolve(name)
    assert cell.name == f"{cell.config_name}.{cell.traffic_name}"
    assert cell.config["name"] == cell.config_name
    conf = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert conf["file"] == f"portbench/configs/{cell.config_name}.json"
    assert (PORTBENCH / "traffic" / f"{cell.traffic_name}.json").exists()
    assert [m.name for m in cell.end_to_end] == [
        "flows_per_s", "batch_p95_ms", "setup_s"]
    assert len(cell.per_layer) == 6
    assert cell.chips == 1
    assert len(cell.traffic["class_weights"]) == 4


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader(name):
    assert callable(cells.reader(name))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        cells.resolve("exitmix-333-k4.nope")


def test_benchmark_file_is_within_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (cells.ROOT / c["file"]).exists()
    names = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in names
        assert set(m["workloads"]) <= set(CELLS)
    assert "setup_s" in names
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


# --- the work count ----------------------------------------------------------
def test_work_count_on_a_hand_sized_example():
    # one subtree a partition: partition 0 splits on feature 1, one leaf
    # exits with class 1, the other goes on to SID 1 (feature 0 and 5)
    leaf = lambda v: trainer.Tree(
        np.asarray([-1], np.int32), np.zeros(1, np.float32),
        np.asarray([-1], np.int32), np.asarray([-1], np.int32),
        np.asarray([v], np.float32))
    t0 = trainer.Tree(np.asarray([1, -1, -1], np.int32),
                      np.asarray([0.5, 0, 0], np.float32),
                      np.asarray([1, -1, -1], np.int32),
                      np.asarray([2, -1, -1], np.int32),
                      np.asarray([[0, 0], [0, 3], [2, 1]], np.float32))
    t1 = trainer.Tree(np.asarray([0, 5, -1, -1, -1], np.int32),
                      np.asarray([1, 2, 0, 0, 0], np.float32),
                      np.asarray([1, 3, -1, -1, -1], np.int32),
                      np.asarray([2, 4, -1, -1, -1], np.int32),
                      np.asarray([[0, 0], [0, 0], [4, 0], [0, 2], [1, 0]],
                                 np.float32))
    m = trainer.Model([trainer.SubTree(0, t0, np.asarray([-2, -1, 1])),
                       trainer.SubTree(1, t1,
                                       np.asarray([-2, -2, -1, -1, -1]))],
                      [1, 2], k=2, n_classes=2)
    X = np.zeros((2, 2, 41), np.float32)
    X[0, 0, 1] = 0.0        # flow 0: left leaf at partition 0, exits
    X[1, 0, 1] = 1.0        # flow 1: right leaf, on to SID 1
    X[1, 1, 0] = 0.0        # left, then feature 5 <= 2: leaf 3
    w = walk.walk(m, X)
    assert w.labels.tolist() == [1, 1]
    assert w.exit_p.tolist() == [0, 1]
    assert w.recircs.tolist() == [0, 1]
    assert w.sid.tolist() == [[0, -1], [0, 1]]
    assert w.leaf_depth.tolist() == [[1, 0], [1, 2]]
    lengths = np.asarray([10, 7])        # windows 5 + 5 and 3 + 4
    got = work.batch_work(m, lengths, w, np.asarray([0, 1, 1]))
    # flow 0 visits 5 packets, flow 1 3 + 4; flow 1 twice
    assert got.bytes == 24 * (5 + 2 * 7) + 12 * 3 + 16 * (3 + 5)
    # 2 ops a packet and feature (1 feature in SID 0, 2 in SID 1) and a
    # comparison a level descended
    assert got.ops == 2 * (5 * 1) + 1 + 2 * (2 * (3 * 1 + 4 * 2) + 1 + 2)
    t, by = got.least_s(3.35e12, 67e12)
    assert by == "bytes" and t == got.bytes / 3.35e12


# --- the result line -----------------------------------------------------------
def test_the_last_line_has_only_the_contracts_keys(tmp_cache):
    out, info = cpu_run(small_cell("exitmix-333-k4.early"))
    assert set(out) <= RESULT_KEYS
    assert list(out)[-1] == "check"
    assert out["correct"] is True
    assert set(out["metrics"]) == {"flows_per_s", "batch_p95_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["check"]["wrong_flows"] == {"value": 0, "max": 0}
    assert out["check"]["flows_compared"]["value"] \
        == harness.SAMPLE_CALLS * 1024
    assert out["attempted"] == info["calls"] * 1024 >= harness.SAMPLE_CALLS
    json.dumps(out)


def test_a_seed_fixes_the_inputs(tmp_cache):
    cell = small_cell("exitmix-333-k4.late")
    a = harness.inputs(cell, cell.traffic, *harness.seeds(2**31 + 9)[:2])
    b = harness.inputs(cell, cell.traffic, *harness.seeds(2**31 + 9)[:2])
    c = harness.inputs(cell, cell.traffic, *harness.seeds(2**31 + 10)[:2])
    assert np.array_equal(a.pool_windows, b.pool_windows)
    assert all(np.array_equal(x, y) for x, y in zip(a.rows, b.rows))
    assert not np.array_equal(a.pool_windows, c.pool_windows)
    # every batch holds each pool flow B / n times
    assert all((np.bincount(r) == 4).all() for r in a.rows)
    assert not np.array_equal(a.rows[0], a.rows[1])


def test_reservoir_samples_calls_from_the_whole_stream():
    r = harness.Reservoir(8, np.random.default_rng(0))
    res = type("R", (), {"labels": 0, "recircs": 0, "exit_partition": 0})
    for i in range(1000):
        r.offer(i, i % 3, res)
    calls = [k.call for k in r.sample()]
    assert len(calls) == 8 and max(calls) > 500


def test_the_timed_window_times_each_call_on_the_host_clock():
    calls = []

    def call(i):
        calls.append(i)
        time.sleep(0.004)
        return type("R", (), {"labels": 0, "recircs": 0,
                              "exit_partition": 0})

    s = types.SimpleNamespace(batches=[0, 1], batch_flows=10, call=call)
    w = harness.timed_window(s, 0.1, harness.Reservoir(
        2, np.random.default_rng(0)))
    assert calls == list(range(w["calls"])) and w["calls"] >= 2
    assert 4.0 <= w["batch_p50_ms"] <= w["batch_p95_ms"]
    assert w["flows_per_s"] == pytest.approx(
        10 * w["calls"] / w["window_s"])


def test_the_span_window_reads_the_dispatch_span_with_no_profiler(
        tmp_cache):
    cell = small_cell("exitmix-333-k4.early")
    pool_rng, batch_rng, sample_rng = harness.seeds(2**31 + 17)
    s = harness.prepare(cell, cell.traffic, pool_rng, batch_rng,
                        torch.device("cpu"))
    profiled = []
    call = s.call

    def spy(i):
        profiled.append(torch.autograd.profiler._is_profiler_enabled)
        return call(i)

    s.call = spy
    spans = harness.span_window(s, harness.Reservoir(2, sample_rng), 3)
    assert profiled == [False] * 3
    assert spans["engine/dispatch"]["calls"] == 3
    assert spans["engine/dispatch"]["s"] > 0
    ctx = harness.Context(None, spans, 3, None)
    assert cells.reader("engine.dispatch_ms")(ctx) == pytest.approx(
        1e3 * spans["engine/dispatch"]["s"] / 3)


def test_trace_reduction_on_hand_made_events():
    tr = trace_lib.Trace(
        calls=2, window=(0, 1000),
        device=[("engine_hop_kernel", 100, 300), ("Memcpy DtoH", 250, 400),
                ("fill", 600, 700), ("outside", 1200, 1300)],
        host=[("run", 0, 1000), ("cudaEventSynchronize", 450, 550)])
    busy, gaps = tr.busy_and_gaps()
    assert busy == pytest.approx(400e-9)
    assert gaps == [(0, 100), (400, 600), (700, 1000)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["engine_hop_kernel", pytest.approx(2e-7)]
    assert dict(bd["idle_gaps"]) == {"run": pytest.approx(4e-7),
                                     "cudaEventSynchronize":
                                         pytest.approx(2e-7)}
    ctx = harness.Context(tr, {"engine/dispatch": {"calls": 2, "s": 0.004}},
                          2, 50e-9)
    read = {m["name"]: cells.reader(m["name"])(ctx)
            for m in BENCH["per_layer"]}
    assert read["hop_kernel_roofline"] == pytest.approx(50.0)
    assert read["walk_mfu"] == pytest.approx(10.0)
    # the fill alone: the event outside the window is not counted
    assert read["walk.other_kernels_ms"] == pytest.approx(1e3 * 100e-9 / 2)
    assert read["fetch.copy_ms"] == pytest.approx(1e3 * 150e-9 / 2)
    assert read["engine.dispatch_ms"] == pytest.approx(2.0)
    assert read["device.idle_share"] == pytest.approx(60.0)
    none = harness.Context(tr, {}, 2, None)
    assert cells.reader("walk_mfu")(none) is None
    assert cells.reader("engine.dispatch_ms")(none) is None


# --- imports -------------------------------------------------------------------
def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in PORTBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not imports.imported_tops(path) & imports.FORBIDDEN, path
    for path in (PORTBENCH / "ref").rglob("*.py"):
        assert imports.PROGRAM not in imports.imported_tops(path), path


def test_names_compare_by_whole_top_level_name():
    assert imports.foreign(["repro_torch", "repro_torch.core", "reprox",
                            "jaxtyping"]) == []
    assert imports.foreign(["repro.core", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "repro.core"]


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(cells.ROOT)!r}, {str(cells.ROOT / 'src')!r}]
import dataclasses
from portbench import cells, harness, imports, model
model.CACHE = __import__('pathlib').Path({str(tmp_path)!r})
cell = cells.resolve('exitmix-333-k4.early')
cell = dataclasses.replace(cell, config=dict(cell.config, dataset=dict(
    cell.config['dataset'], n_flows=900)), traffic=dict(
    cell.traffic, pool_flows=128, batch_flows=256, batches=2))
out, _ = harness.run(cell, seed=5, seconds=0.1, traced=False,
                     device=torch.device('cpu'), t_start=time.perf_counter())
assert out['correct'], out
print(imports.foreign(sys.modules))
"""
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    got = subprocess.run(
        [sys.executable, str(PORTBENCH / "run.py"), "--workload",
         "exitmix-333-k4.early", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cells.ROOT)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


# --- faults the comparison has to catch ------------------------------------------
def _hop_fault(kind):
    from repro_torch.kernels.engine_hop import engine_hop_plain

    def hop(pkts, carry, dev, p, **kw):
        if kind == "unchanged":
            return None                         # the carry stays as it was
        if kind == "half":
            B = pkts.shape[0] // 2              # half the batch left out
            half = tuple(c[:B] for c in carry)
            kw = {key: (v[:B] if key == "regs_out" and v is not None else v)
                  for key, v in kw.items() if key != "survivors_out"}
            if "rows" in kw:
                kw["rows"] = kw["rows"][kw["rows"] < B]
                kw["n_active"] = torch.minimum(kw["n_active"],
                                               torch.tensor(kw["rows"].numel(),
                                                            dtype=torch.int32))
                kw["rows"] = torch.cat([kw["rows"], torch.zeros(
                    B - kw["rows"].numel(), dtype=kw["rows"].dtype)])
            engine_hop_plain(pkts[:B], half, dev, p, **kw)
            return None
        engine_hop_plain(pkts, carry, dev, p, **kw)
        if kind == "altered" and p == 2:
            carry[2][7] = (carry[2][7] + 1) % 4  # one final label altered
        return None
    return hop


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["exitmix-333-k4.early",
                                  "d2-101010-k6.natural"])
def test_a_broken_timed_path_is_not_correct(kind, name, tmp_cache,
                                            monkeypatch):
    from repro_torch.core import inference
    broken = inference.WalkBackend("fused", _hop_fault(kind))
    monkeypatch.setitem(inference._BACKENDS, "fused", broken)
    out, _ = cpu_run(small_cell(name, n_train=1200))
    assert out["correct"] is False
    assert out["check"]["wrong_flows"]["value"] > 0


@pytest.mark.parametrize("name,n_train,pool", [
    # the exit-profile model separates its classes by wide margins: bf16
    # flips a few flows in 10^4, so its control needs the cells' pool
    ("exitmix-333-k4.early", 6000, 65536),
    ("exitmix-333-k4.late", 6000, 65536),
    ("d2-101010-k6.natural", 1500, 2048)])
def test_the_bf16_control_is_not_correct(name, n_train, pool, tmp_cache):
    cell = small_cell(name, n_train=n_train, pool=pool, batch=2 * pool)
    got = control.numbers(cell, 2**31 + 23)
    assert not check.passes(got)
    assert got["wrong_flows"]["value"] > 0
    assert got["flows_compared"]["value"] == harness.SAMPLE_CALLS * 2 * pool


# --- on the card ------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hop kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card_is_correct_and_traced(name, card,
                                                       tmp_cache):
    cell = small_cell(name, n_train=1500, pool=4096, batch=65536)
    out, info = harness.run(cell, seed=2**31 + 41, seconds=0.5,
                            traced=False, device=card,
                            t_start=time.perf_counter())
    assert out["correct"] and out["device"]["platform"] == "gpu"
    out, info = harness.run(cell, seed=2**31 + 42, seconds=0.5,
                            traced=True, device=card,
                            t_start=time.perf_counter(), trace_calls=20)
    assert out["correct"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert "hop_kernel_roofline" in out["metrics"]
    assert out["metrics"]["hop_kernel_roofline"]["value"] <= 105
