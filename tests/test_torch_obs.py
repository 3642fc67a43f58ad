"""The port's labelled metrics against the JAX package's registry.

* label identity: ``(name, sorted labels)``, whatever the order the labels
  come in; snapshot keys ``name{k="v",...}`` equal the JAX registry's for
  the same calls;
* the engine's counters: after the same ``Engine.run`` (dense and
  compacted), ``run_looped`` and ``run_streaming`` on the very same tables
  (``convert``), the port's process registry holds the JAX package's
  ``engine_hop_survivors_total{hop}``, ``engine_compact_bucket_total{hop,
  cap}``, ``engine_dispatches_total{backend}`` and
  ``stream_chunks_total{backend}`` values;
* the spans ``engine/dispatch``, ``engine/fetch``, ``stream/dispatch`` and
  ``stream/fetch``; histograms only while ``SPLIDT_OBS`` is on;
* the exposition: ports of tests/test_obs.py's registry, reporter and
  span-tree cases, and after the same records (labelled metrics
  included) ``to_prometheus()`` byte-equal and ``to_json()`` equal to the
  JAX registry's;
* the trainer's metrics: after ``train_partitioned_dt`` on the same
  windows, ``fit_trees_total{trainer="numpy"}`` equals JAX's and
  ``{trainer="torch"}`` equals JAX's ``{trainer="jax"}``;
  ``fit_level_seconds{trainer}`` holds one sample a partition while obs
  is on and none while it is off.

Inputs are the shared ``trained_pdt`` fixture (d2, 840 training flows,
(2, 3, 2), k = 4), handed to both packages.
"""
import json
import types
import urllib.request

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.convert import engine_tables_from_arrays
from repro_torch.core.inference import Engine, EngineOptions
from repro_torch.obs import Histogram, MetricRegistry, MetricsReporter
from repro_torch.serve import run_streaming


@pytest.fixture(scope="module")
def jx(trained_pdt):
    """The JAX package's engine, registry and streaming, and the port's
    engine over the same tables."""
    pytest.importorskip("jax.numpy")
    from repro import obs as jobs
    from repro.core.inference import Engine as JEngine
    from repro.core.inference import EngineOptions as JOptions
    from repro.flows.windows import window_packets
    from repro.serve.streaming import run_streaming as j_run_streaming
    pdt, _, tr = trained_pdt
    jeng = JEngine.from_model(pdt)
    arrays = {n: np.asarray(getattr(jeng.dev, n)) for n in jeng.dev._fields}
    eng = Engine.from_tables(engine_tables_from_arrays(
        arrays, n_subtrees=jeng.ret.n_subtrees,
        n_partitions=pdt.n_partitions, n_classes=jeng.ret.n_classes,
        device="cpu"))
    return types.SimpleNamespace(
        obs=jobs, eng=jeng, Options=JOptions, stream=j_run_streaming,
        port=eng, wp=window_packets(tr, 3))


def _values(snapshot: dict, kind: str = "counters") -> dict:
    return {name: m["value"] for name, m in snapshot[kind].items()}


def _fresh(jx):
    """New process registries in both packages; returns a restorer."""
    jprev = jx.obs.set_registry(jx.obs.MetricRegistry())
    prev = obs.set_registry(MetricRegistry())

    def restore():
        jx.obs.set_registry(jprev)
        obs.set_registry(prev)
    return restore


def _engine_counters(snap: dict) -> dict:
    return {k: v for k, v in _values(snap).items()
            if k.startswith(("engine_", "stream_"))}


def test_label_identity():
    reg = MetricRegistry()
    a = reg.counter("d_total", labels={"backend": "fused"})
    b = reg.counter("d_total", labels={"backend": "cuda"})
    assert a is not b
    a.inc(3)
    c = reg.counter("d_total", labels={"backend": "fused"})
    assert c is a and c.value == 3
    # label order does not matter for identity
    x = reg.counter("e_total", labels={"hop": "1", "cap": "128"})
    assert reg.counter("e_total", labels={"cap": "128", "hop": "1"}) is x
    assert reg.counter("d_total") is not a          # no labels: its own
    snap = reg.snapshot()
    assert snap["counters"]['d_total{backend="fused"}']["value"] == 3
    assert 'e_total{cap="128",hop="1"}' in snap["counters"]
    h = reg.histogram("h_us", edges=[1.0, 10.0], labels={"backend": "x"})
    assert reg.histogram("h_us", labels={"backend": "x"}) is h
    with pytest.raises(ValueError, match="must pass edges"):
        reg.histogram("h_us", labels={"backend": "y"})
    g = reg.gauge("g", labels={"a": 1})
    assert g.labels == (("a", "1"),)


def test_snapshots_equal_jax_for_the_same_calls(jx):
    """The same counter, gauge and histogram calls, labelled and not, give
    the JAX registry's snapshot: keys, values, edges, counts, help."""
    regs = (MetricRegistry(), jx.obs.MetricRegistry())
    for reg in regs:
        reg.counter("engine_dispatches_total", "walk calls",
                    labels={"backend": "fused"}).inc(2)
        reg.counter("engine_compact_bucket_total", "rung",
                    labels={"hop": "2", "cap": "256"}).inc()
        reg.counter("serve_packets_total", "packets").inc(7)
        reg.gauge("g", "a gauge", labels={"z": "1", "a": "0"}).set(2.5)
        reg.histogram("tune_probe_us", "probe", edges=[10.0, 100.0],
                      labels={"backend": "looped"}).record_many(
                          [5.0, 50.0, 500.0, 50.0])
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.mark.parametrize("compact", [False, True])
def test_engine_run_counters_equal_jax(jx, compact):
    restore = _fresh(jx)
    try:
        jx.eng.run(jx.wp, with_trace=False,
                   options=jx.Options(impl="fused", compact=compact))
        jx.eng.run(jx.wp[:100], options=jx.Options(impl="fused",
                                                   compact=compact))
        jsnap = jx.obs.get_registry().snapshot()
        jx.port.run(jx.wp, with_trace=False,
                    options=EngineOptions(impl="fused", compact=compact))
        jx.port.run(jx.wp[:100], options=EngineOptions(impl="fused",
                                                       compact=compact))
        snap = obs.get_registry().snapshot()
    finally:
        restore()
    got, want = _engine_counters(snap), _engine_counters(jsnap)
    assert got == want
    assert got['engine_dispatches_total{backend="fused"}'] == 2
    assert any(k.startswith("engine_compact_bucket_total")
               for k in got) == compact


def test_looped_counters_equal_jax(jx):
    restore = _fresh(jx)
    try:
        jx.eng.run_looped(jx.wp, options=jx.Options(compact=True))
        jsnap = jx.obs.get_registry().snapshot()
        jx.port.run_looped(jx.wp, options=EngineOptions(compact=True))
        snap = obs.get_registry().snapshot()
    finally:
        restore()
    assert _engine_counters(snap) == _engine_counters(jsnap)
    assert 'engine_dispatches_total{backend="looped"}' in _values(snap)


@pytest.mark.parametrize("micro_batch,compact", [(64, False), (64, True),
                                                 (10_000, True)])
def test_streaming_counters_equal_jax(jx, micro_batch, compact):
    """``stream_chunks_total{backend="fused"}``, ``engine_dispatches_total
    {backend="fused"}`` (one a chunk) and the per-hop counters recorded
    once a call, as the JAX scheduler records them."""
    restore = _fresh(jx)
    try:
        jx.stream(jx.eng, jx.wp, options=jx.Options(
            impl="fused", micro_batch=micro_batch, compact=compact))
        jsnap = jx.obs.get_registry().snapshot()
        run_streaming(jx.port, jx.wp, options=EngineOptions(
            impl="fused", micro_batch=micro_batch, compact=compact))
        snap = obs.get_registry().snapshot()
    finally:
        restore()
    got = _engine_counters(snap)
    assert got == _engine_counters(jsnap)
    chunks = -(-jx.wp.shape[0] // micro_batch)
    assert got['stream_chunks_total{backend="fused"}'] == chunks
    assert got['engine_dispatches_total{backend="fused"}'] == chunks


def test_engine_and_stream_spans(jx):
    prev = obs.set_enabled(True)
    obs.reset_spans()
    try:
        jx.port.run(jx.wp[:50], with_trace=False)
        run_streaming(jx.port, jx.wp[:50],
                      options=EngineOptions(micro_batch=20))
        spans = obs.span_totals()
    finally:
        obs.set_enabled(prev)
        obs.reset_spans()
    assert spans["engine/dispatch"]["calls"] == 1
    assert spans["engine/fetch"]["calls"] == 1
    assert spans["stream/dispatch"]["calls"] == 3
    assert spans["stream/fetch"]["calls"] == 3


def test_histograms_only_while_obs_is_on(jx, tmp_path, monkeypatch):
    """``tune_probe_us{backend}`` is a histogram, recorded only with
    ``SPLIDT_OBS`` on; ``tune_probes_total{backend}`` counts either way."""
    from repro_torch.tuning import autotune
    monkeypatch.setenv("SPLIDT_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    for on in (False, True):
        reg = MetricRegistry()
        prev, was = obs.set_registry(reg), obs.set_enabled(on)
        try:
            autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                     repeat=1, probe_flows=32, force=True)
        finally:
            obs.set_registry(prev)
            obs.set_enabled(was)
        snap = reg.snapshot()
        assert snap["counters"]['tune_probes_total{backend="fused"}'][
            "value"] == 1
        assert ('tune_probe_us{backend="fused"}' in snap["histograms"]) == on


# ---------------------------------------------------------------------------
# exposition, reporter and span tree (ports of tests/test_obs.py)
# ---------------------------------------------------------------------------
def test_gauge_set_add():
    g = MetricRegistry().gauge("x")
    g.set(2.5)
    g.add(-0.5)
    assert g.value == 2.0


def test_histogram_bucketing():
    h = Histogram("h", edges=[1.0, 10.0, 100.0])
    h.record(0.5)                       # below first edge
    h.record_many([1.0, 5.0, 50.0, 1e9])  # edge goes RIGHT (1.0 -> [1,10))
    assert [int(c) for c in h.counts] == [1, 2, 1, 1]
    assert h.total == 5
    assert h.bucket_of(0.0) == 0 and h.bucket_of(1.0) == 1
    assert h.bucket_of(float("inf")) == 3
    assert h.quantile(0.5) == 10.0      # upper edge of the median bucket
    assert h.quantile(1.0) == float("inf")
    assert np.isnan(Histogram("e", edges=[1.0]).quantile(0.5))
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_snapshot_delta():
    reg = MetricRegistry()
    c = reg.counter("c_total")
    h = reg.histogram("h", edges=[1.0, 2.0])
    c.inc(5)
    h.record(0.5)
    before = reg.snapshot()
    c.inc(2)
    h.record(1.5)
    reg.gauge("g").set(3.0)
    d = MetricRegistry.delta(before, reg.snapshot())
    assert d["counters"]["c_total"]["value"] == 2
    assert d["histograms"]["h"]["counts"] == [0, 1, 0]
    assert d["histograms"]["h"]["total"] == 1
    assert d["gauges"]["g"]["value"] == 3.0


def test_prometheus_exposition():
    reg = MetricRegistry()
    reg.counter("pkts_total", "packets").inc(7)
    reg.gauge("load").set(0.25)
    h = reg.histogram("lat_seconds", "latency", edges=[0.1, 1.0])
    h.record_many([0.05, 0.5, 5.0])
    text = reg.to_prometheus()
    assert "# TYPE pkts_total counter" in text
    assert "pkts_total 7" in text
    assert "load 0.25" in text
    # histogram buckets are cumulative and end at +Inf
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_count 3" in text
    # JSON exposition round-trips
    assert json.loads(reg.to_json())["counters"]["pkts_total"]["value"] == 7


def test_reporter_jsonl(tmp_path):
    reg = MetricRegistry()
    reg.counter("n_total").inc(9)
    path = tmp_path / "metrics.jsonl"
    rep = MetricsReporter(str(path), registry=reg, interval_s=3600.0)
    rep.dump_once()
    reg.counter("n_total").inc(1)
    rep.close()  # close flushes one final line
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["seq"] for x in lines] == [0, 1]
    assert lines[0]["counters"]["n_total"]["value"] == 9
    assert lines[1]["counters"]["n_total"]["value"] == 10
    del lines[1]["seq"]
    assert lines[1] == reg.snapshot()


def test_reporter_context_manager_dumps_on_a_timer(tmp_path):
    """``with MetricsReporter(...)`` starts the dump thread and ``close``
    stops it: lines arrive every interval, the last at exit."""
    reg = MetricRegistry()
    reg.counter("t_total").inc()
    path = tmp_path / "m.jsonl"
    with MetricsReporter(str(path), registry=reg, interval_s=0.05) as rep:
        thread = rep._thread
        for _ in range(200):
            if path.exists() and path.read_text().count("\n") >= 2:
                break
            thread.join(timeout=0.05)
    assert not thread.is_alive()
    seqs = [json.loads(x)["seq"] for x in path.read_text().splitlines()]
    assert len(seqs) >= 3 and seqs == list(range(len(seqs)))


def test_reporter_http_scrape():
    reg = MetricRegistry()
    reg.counter("scraped_total").inc(4)
    reg.counter("d_total", labels={"backend": "cuda"}).inc(2)
    rep = MetricsReporter(None, registry=reg, http_port=0)
    try:
        url = f"http://127.0.0.1:{rep.http_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    finally:
        rep.close()
    assert rep.http_port is None
    assert "scraped_total 4" in body
    assert body == reg.to_prometheus()
    assert ctype == "text/plain; version=0.0.4"


def test_span_nesting_and_tree():
    prev = obs.set_enabled(True)
    obs.reset_spans()
    try:
        for _ in range(3):
            with obs.span("tick"):
                with obs.span("tick/pack"):
                    pass
                with obs.span("tick/dispatch"):
                    pass
        tree = obs.span_tree()
        totals = obs.span_totals()
    finally:
        obs.set_enabled(prev)
        obs.reset_spans()
    lines = tree.splitlines()
    assert [ln.split()[0] for ln in lines] == ["tick", "tick/dispatch",
                                               "tick/pack"]
    # re-entry aggregates into one node, not three; children indent
    assert all("       3 calls" in ln for ln in lines)
    assert lines[1].startswith("  tick/dispatch")
    assert totals["tick > tick/pack"]["calls"] == 3
    assert obs.span_tree() == "(no spans recorded)"


def test_span_opens_its_profiler_range_only_while_profiling():
    """A span is timed either way; its ``record_function`` range exists
    only inside a running ``torch.profiler``, which still attributes to
    it what ran inside."""
    import torch
    prev = obs.set_enabled(True)
    obs.reset_spans()
    try:
        with obs.span("probe/off") as sp:
            assert sp._range is None
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("probe/on") as sp:
                assert sp._range is not None
                torch.ones(4).sum()
        totals = obs.span_totals()
    finally:
        obs.set_enabled(prev)
        obs.reset_spans()
    names = {e.key for e in prof.key_averages()}
    assert "probe/on" in names and "probe/off" not in names
    assert totals["probe/off"]["calls"] == totals["probe/on"]["calls"] == 1


def test_hop_counters_follow_the_installed_registry(jx):
    """``Engine.run`` keeps its hop counters per registry: each registry
    installed in turn gets its own counts, none leak into another."""
    eng, wp = jx.port, jx.wp[:64]
    regs = [MetricRegistry(), MetricRegistry()]
    prev = obs.get_registry()
    try:
        for reg, runs in zip(regs, (1, 2)):
            obs.set_registry(reg)
            for _ in range(runs):
                res = eng.run(wp, with_trace=False)
    finally:
        obs.set_registry(prev)
    ex = res.exit_partition
    want = [int(np.count_nonzero((ex < 0) | (ex >= p)))
            for p in range(eng.tables.n_partitions)]
    for reg, runs in zip(regs, (1, 2)):
        got = [reg.counter("engine_hop_survivors_total",
                           labels={"hop": str(p)}).value
               for p in range(eng.tables.n_partitions)]
        assert got == [runs * w for w in want]


@pytest.fixture(scope="module")
def jobs():
    """The JAX package's ``repro.obs``."""
    pytest.importorskip("jax.numpy")
    from repro import obs as jobs
    return jobs


def _same_records(reg) -> None:
    """One sequence of records, labelled and not, with helps, integral and
    fractional gauges, infinities and a histogram sample past its last
    edge."""
    reg.counter("serve_packets_total", "packets").inc(7)
    reg.counter("engine_dispatches_total", "walk calls",
                labels={"backend": "fused"}).inc(2)
    reg.counter("engine_dispatches_total", "walk calls",
                labels={"backend": "cuda"}).inc(5)
    reg.counter("engine_compact_bucket_total", "rung",
                labels={"hop": "2", "cap": "256"}).inc()
    reg.gauge("load", "share").set(0.25)
    reg.gauge("slots").set(8)
    reg.gauge("g", "a gauge", labels={"z": "1", "a": "0"}).set(float("inf"))
    reg.gauge("neg").add(-1.5)
    reg.histogram("serve_ttd_seconds", "latency",
                  edges=obs.exp_edges(1e-4, 100.0, 13)).record_many(
                      [3e-4, 0.02, 0.02, 7.5, 250.0])
    reg.histogram("tune_probe_us", "probe", edges=[10.0, 100.0],
                  labels={"backend": "looped"}).record_many(
                      [5.0, 50.0, 500.0, 50.0])


def test_exposition_equals_jax_after_the_same_records(jobs):
    regs = (MetricRegistry(), jobs.MetricRegistry())
    for reg in regs:
        _same_records(reg)
    assert regs[0].to_prometheus() == regs[1].to_prometheus()
    assert regs[0].to_json() == regs[1].to_json()
    assert regs[0].to_json(indent=2) == regs[1].to_json(indent=2)
    before = [r.snapshot() for r in regs]
    for reg in regs:
        reg.counter("serve_packets_total").inc(3)
        reg.histogram("tune_probe_us", labels={"backend": "looped"}).record(
            1.0)
    deltas = [type(r).delta(b, r.snapshot()) for r, b in zip(regs, before)]
    assert deltas[0] == deltas[1]


def test_trainer_counters_equal_jax(jobs, trained_pdt):
    """``train_partitioned_dt`` on the same windows in both packages: the
    subtree counts per trainer (``numpy`` == ``numpy``, ``torch`` ==
    JAX's ``jax``), and one ``fit_level_seconds`` sample a partition."""
    from repro.core.partition import train_partitioned_dt as j_train
    from repro_torch.core.partition import train_partitioned_dt
    _, Xw, tr = trained_pdt
    kw = dict(partition_sizes=[2, 3, 2], k=4)
    jprev = jobs.set_registry(jobs.MetricRegistry())
    prev = obs.set_registry(MetricRegistry())
    jwas, was = jobs.set_enabled(True), obs.set_enabled(True)
    try:
        jpdts = [j_train(Xw, tr.labels, trainer=t, **kw)
                 for t in ("numpy", "jax")]
        pdts = [train_partitioned_dt(Xw, tr.labels, trainer="numpy", **kw),
                train_partitioned_dt(Xw, tr.labels, trainer="torch",
                                     device="cpu", **kw)]
        jsnap = jobs.get_registry().snapshot()
        snap = obs.get_registry().snapshot()
    finally:
        jobs.set_registry(jprev)
        obs.set_registry(prev)
        jobs.set_enabled(jwas)
        obs.set_enabled(was)
    want = {t: jsnap["counters"][f'fit_trees_total{{trainer="{t}"}}'][
        "value"] for t in ("numpy", "jax")}
    got = {t: snap["counters"][f'fit_trees_total{{trainer="{t}"}}'][
        "value"] for t in ("numpy", "torch")}
    assert got == {"numpy": want["numpy"], "torch": want["jax"]}
    assert got["torch"] == len(pdts[1].subtrees) == len(jpdts[1].subtrees)
    for t, p in (("numpy", pdts[0]), ("torch", pdts[1])):
        h = snap["histograms"][f'fit_level_seconds{{trainer="{t}"}}']
        assert h["total"] == p.n_partitions
        assert h["edges"] == jsnap["histograms"][
            'fit_level_seconds{trainer="numpy"}']["edges"]


def test_fit_level_seconds_only_while_obs_is_on(trained_pdt):
    from repro_torch.core.partition import train_partitioned_dt
    _, Xw, tr = trained_pdt
    for on in (False, True):
        reg = MetricRegistry()
        prev, was = obs.set_registry(reg), obs.set_enabled(on)
        try:
            pdt = train_partitioned_dt(Xw, tr.labels,
                                       partition_sizes=[2, 3, 2], k=4)
        finally:
            obs.set_registry(prev)
            obs.set_enabled(was)
        snap = reg.snapshot()
        assert snap["counters"]['fit_trees_total{trainer="numpy"}'][
            "value"] == len(pdt.subtrees)
        hist = snap["histograms"].get('fit_level_seconds{trainer="numpy"}')
        assert (hist["total"] if hist else 0) == (pdt.n_partitions if on
                                                  else 0)


def test_nan_gauge_exposes_as_nan(jobs):
    """A gauge set to NaN renders as Prometheus ``NaN``; the JAX
    package's ``_fmt`` raises there (``int(nan)``), so its exposition of
    the same registry fails (a reference-side fault, ROADMAP C)."""
    regs = (MetricRegistry(), jobs.MetricRegistry())
    for reg in regs:
        reg.gauge("ratio").set(float("nan"))
    assert regs[0].to_prometheus() == "# TYPE ratio gauge\nratio NaN\n"
    with pytest.raises(ValueError):
        regs[1].to_prometheus()
