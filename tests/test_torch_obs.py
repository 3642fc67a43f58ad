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
  ``stream/fetch``; histograms only while ``SPLIDT_OBS`` is on.

Inputs are the shared ``trained_pdt`` fixture (d2, 840 training flows,
(2, 3, 2), k = 4), handed to both packages.
"""
import types

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.convert import engine_tables_from_arrays
from repro_torch.core.inference import Engine, EngineOptions
from repro_torch.obs import MetricRegistry
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
