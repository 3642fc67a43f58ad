"""The port's router (``tuning/costmodel.py``, ``tuning/autotune.py``)
against the JAX package's ``repro.tuning``, on the CPU; and on the card.

* the shared model: ``ShapeInfo.from_engine`` equals JAX's on the same
  tables; ``work_terms`` and ``estimate_us`` of the ``fused`` and
  ``looped`` plans (the JAX package's terms) equal JAX's term by term on
  the same shapes and coefficients, the terms of one package's other
  backends being zero in the other; ``fit_coefficients`` on the same
  samples is within 1e-9 relative of JAX's; ``choose_plan`` restricted
  to ``fused``/``looped`` picks JAX's plan; the tick terms and
  ``choose_tick_engine`` equal JAX's;
* the hop kernel's terms (``cuda``: one launch a hop, window bytes,
  compare work, exact survivors, one permutation a compacted hop) and
  that ``cuda`` is offered only for a CUDA engine;
* the autotune cache: round trip, corrupt and foreign files, the key
  (device fingerprint, shape, restrictions), a pinned ``compact`` never
  served an ``auto`` plan, timing, cache hits, the no-timing fallback
  and an unwritable cache that never raises;
* routing never changes bits: ``impl="auto"``/``"tuned"`` and
  ``compact="auto"`` on ``Engine.run`` and ``run_streaming`` equal the
  backend they resolve to and the oracle; ``FlowTableServer(tick_engine=
  "auto")`` serves the JAX server's verdicts, stats and registry.

Coefficients for the comparisons are drawn from a numpy seed; JAX is
imported in a fixture, so on the card's machine the ``gpu`` tests run.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.convert import engine_tables_from_arrays
from repro_torch.core.inference import (
    Engine, EngineOptions, backend_for_plan, get_backend,
)
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.flows.synthetic import make_dataset, make_profile_dataset
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.serve import FlowTableServer, StreamVerdicts, run_streaming
from repro_torch.tuning import (
    Coefficients, Plan, ShapeInfo, calibrate, candidate_plans, choose_plan,
    choose_tick_engine, choose_tick_plan, estimate_us, fit_coefficients,
    tick_work_terms, work_terms,
)
from repro_torch.tuning import costmodel
from repro_torch.tuning.costmodel import TERMS
from repro_torch.tuning.autotune import (
    CACHE_ENV, NO_TIME_ENV, autotune, cache_key, device_fingerprint,
    get_plan, load_cache, save_cache,
)


@pytest.fixture(scope="module")
def jx(trained_pdt):
    """``repro.tuning``, the JAX engine, and the port's engine over the
    same tables with the training split's windows."""
    pytest.importorskip("jax.numpy")
    import repro.tuning as jt
    from repro.core.inference import Engine as JEngine
    from repro.core.inference import EngineOptions as JOptions
    from repro.flows.windows import window_packets as j_window_packets
    pdt, Xw, tr = trained_pdt
    jeng = JEngine.from_model(pdt)
    arrays = {n: np.asarray(getattr(jeng.dev, n)) for n in jeng.dev._fields}
    eng = Engine.from_tables(engine_tables_from_arrays(
        arrays, n_subtrees=jeng.ret.n_subtrees,
        n_partitions=pdt.n_partitions, n_classes=jeng.ret.n_classes,
        device="cpu"))
    return types.SimpleNamespace(
        t=jt, eng=jeng, Options=JOptions, port=eng, pdt=pdt, Xw=Xw,
        wp=j_window_packets(tr, 3), tr=tr)


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(CACHE_ENV, path)
    return path


def _shape(B=1024, S=9, k=4, P=3, W=32, T=8, L=16, **kw):
    return ShapeInfo(B=B, S=S, k=k, P=P, W=W, T=T, L=L, **kw)


def _jshape(jx, s: ShapeInfo):
    return jx.t.ShapeInfo(**dataclasses.asdict(s))


def _terms(vec, names) -> dict:
    return dict(zip(names, (float(v) for v in vec)))


_SHAPES = [
    dict(B=4096, S=9, k=4, P=3, W=24, T=16, L=16),
    dict(B=1000, S=31, k=6, P=4, W=65, T=8, L=64, n_devices=8),
    dict(B=2 ** 20, S=30, k=4, P=3, W=65, T=8, L=8,
         survivors=(1.0, 0.77, 0.51)),
    dict(B=300, S=5, k=41, P=2, W=1, T=3, L=700, survivors=(1.0, 0.01)),
    dict(B=0, S=1, k=1, P=1, W=1, T=1, L=1),
]


def _plans():
    out = []
    for backend in ("fused", "looped"):
        for compact in (False, True):
            for floor in (16, 128):
                out.append(dict(backend=backend, compact=compact,
                                compact_floor=floor))
    return out


def _coeffs(seed: int) -> dict:
    """Random positive weights by term name, for both packages."""
    rng = np.random.default_rng(seed)
    names = sorted(set(TERMS) | {"tr_pallas", "grid"})
    return {n: float(rng.uniform(1e-4, 10.0)) for n in names}


def _port_coeffs(w: dict) -> Coefficients:
    return Coefficients(**{t: w[t] for t in TERMS})


def _jax_coeffs(jx, w: dict):
    return jx.t.Coefficients(**{t: w[t] for t in jx.t.costmodel.TERMS})


# ---------------------------------------------------------------------------
# the shared cost model, against JAX's
# ---------------------------------------------------------------------------
def test_shape_from_engine_equals_jax(jx):
    s = ShapeInfo.from_engine(jx.port, jx.wp)
    j = jx.t.ShapeInfo.from_engine(jx.eng, jx.wp)
    assert dataclasses.asdict(s) == dataclasses.asdict(j)
    assert s.key() == j.key()
    s2 = ShapeInfo.from_engine(jx.port, None, B=77, W=1, n_devices=8,
                               survivors=(1.0, 0.5, 0.25))
    j2 = jx.t.ShapeInfo.from_engine(jx.eng, None, B=77, W=1, n_devices=8,
                                    survivors=(1.0, 0.5, 0.25))
    assert dataclasses.asdict(s2) == dataclasses.asdict(j2)
    with pytest.raises(ValueError, match="explicit B and W"):
        ShapeInfo.from_engine(jx.port, None, B=3)


def test_shape_and_plan_validation_equal_jax(jx):
    for bad in (dict(S=0), dict(B=-1), dict(survivors=(1.0, 0.5))):
        with pytest.raises(ValueError) as want:
            jx.t.ShapeInfo(**{**dataclasses.asdict(_shape()), **bad})
        with pytest.raises(ValueError) as got:
            ShapeInfo(**{**dataclasses.asdict(_shape()), **bad})
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown backend"):
        Plan(backend="pallas")
    assert Plan(backend="cuda", compact=True).describe() == \
        "cuda compact source=costmodel"


@pytest.mark.parametrize("shape", range(len(_SHAPES)))
@pytest.mark.parametrize("plan", _plans(),
                         ids=lambda p: "{backend}-c{compact:d}-f"
                                       "{compact_floor}".format(**p))
def test_work_terms_and_estimates_equal_jax(jx, shape, plan):
    s = ShapeInfo(**_SHAPES[shape])
    got = _terms(work_terms(s, Plan(**plan)), TERMS)
    want = _terms(jx.t.work_terms(_jshape(jx, s), jx.t.Plan(**plan)),
                  jx.t.costmodel.TERMS)
    for name in set(got) | set(want):
        assert got.get(name, 0.0) == want.get(name, 0.0), name
    w = _coeffs(shape)
    est = estimate_us(s, Plan(**plan), _port_coeffs(w))
    j_est = jx.t.estimate_us(_jshape(jx, s), jx.t.Plan(**plan),
                             _jax_coeffs(jx, w))
    assert est == pytest.approx(j_est, rel=1e-12, abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_coefficients_equal_jax(jx, seed):
    """The same (shape, plan, us) samples, fused and looped plans over
    varied shapes, give JAX's fit within 1e-9 relative."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(12):
        s = _shape(B=int(rng.integers(64, 8192)), W=int(rng.integers(1, 70)),
                   L=int(rng.integers(2, 64)), T=int(rng.integers(2, 32)),
                   survivors=(1.0, float(rng.uniform(0.1, 1)),
                              float(rng.uniform(0.01, 0.1))))
        p = dict(backend=["fused", "looped"][int(rng.integers(0, 2))],
                 compact=bool(rng.integers(0, 2)))
        samples.append((s, p, float(rng.uniform(100, 1e5))))
    base = _coeffs(seed + 10)
    got = fit_coefficients([(s, Plan(**p), us) for s, p, us in samples],
                           base=_port_coeffs(base))
    want = jx.t.fit_coefficients(
        [(_jshape(jx, s), jx.t.Plan(**p), us) for s, p, us in samples],
        base=_jax_coeffs(jx, base))
    for t in TERMS:
        if t in jx.t.costmodel.TERMS:
            assert getattr(got, t) == pytest.approx(getattr(want, t),
                                                    rel=1e-9, abs=1e-12), t
        else:
            assert getattr(got, t) == base[t], t    # unsupported: base
    with pytest.raises(ValueError, match="at least one"):
        fit_coefficients([])


def test_relative_fit_weighs_each_sample_by_its_time():
    """``relative=True`` is the unweighted fit of the rows divided by
    their measured time: it recovers exact coefficients as the plain fit
    does, and on noisy samples it fits the small probes in relative error
    where the plain fit lets the largest set the weights."""
    truth = costmodel.Coefficients(call=40.0, sync=15.0, fw=2e-4,
                                   tr_dense=1e-4, sort=0.0, win_bytes=0.0,
                                   compare=0.0, perm=0.0)
    sizes = (256, 1024, 4096, 65536, 262144)
    plans = [Plan(backend="looped")]
    clean = [(_shape(B=b, W=65), p, estimate_us(_shape(B=b, W=65), p, truth))
             for b in sizes for p in plans]
    for relative in (False, True):
        got = fit_coefficients(clean, relative=relative)
        assert estimate_us(*clean[0][:2], got) == pytest.approx(
            clean[0][2], rel=1e-6)
    # the largest probe 5 % slow: the plain fit moves the small probe's
    # estimate by far more, relatively, than the weighted one
    noisy = clean[:-1] + [(clean[-1][0], clean[-1][1], clean[-1][2] * 1.05)]
    small = clean[0]
    err = {rel: abs(estimate_us(*small[:2], fit_coefficients(
        noisy, relative=rel)) / small[2] - 1) for rel in (False, True)}
    assert err[True] < err[False]


@pytest.mark.parametrize("shape", range(len(_SHAPES) - 1))
@pytest.mark.parametrize("compact", [False, True, "auto"])
def test_choose_plan_equals_jax(jx, shape, compact):
    s = ShapeInfo(**_SHAPES[shape])
    for seed in (shape, shape + 7):
        w = _coeffs(seed)
        coeffs = {"fused": _port_coeffs(w),
                  "looped": _port_coeffs(_coeffs(seed + 100))}
        jcoeffs = {"fused": _jax_coeffs(jx, w),
                   "looped": _jax_coeffs(jx, _coeffs(seed + 100))}
        got = choose_plan(s, backends=("fused", "looped"), compact=compact,
                          coeffs=coeffs)
        want = jx.t.choose_plan(_jshape(jx, s), backends=("fused", "looped"),
                                compact=compact, coeffs=jcoeffs)
        assert (got.backend, got.compact, got.compact_floor, got.source) == \
            (want.backend, want.compact, want.compact_floor, want.source)
        assert got.est_us == pytest.approx(want.est_us, rel=1e-9)


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
@pytest.mark.parametrize("ranks,drains", [(4, 1.0), (64, 3.0), (1, 0.0)])
def test_tick_terms_and_choice_equal_jax(jx, tick_engine, ranks, drains):
    s = _shape(B=16384, W=1)
    got = _terms(tick_work_terms(s, Plan(backend="fused"), ranks=ranks,
                                 drains=drains, tick_engine=tick_engine),
                 TERMS)
    want = _terms(jx.t.tick_work_terms(
        _jshape(jx, s), jx.t.Plan(backend="fused"), ranks=ranks,
        drains=drains, tick_engine=tick_engine), jx.t.costmodel.TERMS)
    for name in set(got) | set(want):
        assert got.get(name, 0.0) == want.get(name, 0.0), name
    for seed in range(4):
        w = _coeffs(seed)
        assert choose_tick_engine(
            s, ranks=ranks, drains=drains, coeffs=_port_coeffs(w)) == \
            jx.t.choose_tick_engine(_jshape(jx, s), ranks=ranks,
                                    drains=drains,
                                    coeffs=_jax_coeffs(jx, w))
    with pytest.raises(ValueError, match="unknown tick engine"):
        tick_work_terms(s, Plan(backend="fused"), tick_engine="warp")


@pytest.mark.parametrize("seed", [0, 3])
def test_choose_tick_plan_equals_jax_on_the_plain_backend(jx, seed):
    s = _shape(B=4096, W=1)
    w = _coeffs(seed)
    te, plan = choose_tick_plan(s, backends=("fused",),
                                coeffs={"fused": _port_coeffs(w)})
    j_te, j_plan = jx.t.choose_tick_plan(
        _jshape(jx, s), backends=("fused",),
        coeffs={"fused": _jax_coeffs(jx, w)})
    assert (te, plan.backend, plan.compact) == \
        (j_te, j_plan.backend, j_plan.compact)
    assert plan.est_us == pytest.approx(j_plan.est_us, rel=1e-9)
    # the card's tick kernel: offered on the cuda platform only
    te, plan = choose_tick_plan(s, platform="cuda")
    assert (te, plan.backend) == ("fused", "cuda")
    assert choose_tick_plan(s)[1].backend == "fused"


# ---------------------------------------------------------------------------
# the hop kernel's terms
# ---------------------------------------------------------------------------
def test_cuda_terms_count_launches_bytes_and_exact_survivors():
    s = _shape(B=1000, P=3, W=65, k=4, T=8, L=16, survivors=(1.0, 0.5, 0.1))
    dense = _terms(work_terms(s, Plan(backend="cuda")), TERMS)
    unit = 4 * 8 + 16 * 4
    assert dense == dict.fromkeys(TERMS, 0.0) | {
        "call": 3.0, "sync": 1.0, "win_bytes": 3 * 1000 * 65 * 6 * 4.0,
        "compare": 3 * 1000.0 * unit}
    comp = _terms(work_terms(s, Plan(backend="cuda", compact=True,
                                     compact_floor=64)), TERMS)
    rows = 1000 + 500 + 100                       # exact, no ladder
    assert comp == dict.fromkeys(TERMS, 0.0) | {
        "call": 5.0, "sync": 1.0, "win_bytes": rows * 65 * 6 * 4.0,
        "compare": rows * float(unit), "perm": 2 * 1000.0}
    # the plain fused hop keeps the ladder: 500 -> 512, 100 -> 128
    fused = _terms(work_terms(s, Plan(backend="fused", compact=True,
                                      compact_floor=64)), TERMS)
    assert fused["fw"] == (1000 + 512 + 128) * 65 * 4
    # two devices: each walks its half
    s2 = dataclasses.replace(s, n_devices=2)
    assert _terms(work_terms(s2, Plan(backend="cuda")), TERMS)[
        "win_bytes"] == dense["win_bytes"] / 2


def test_cuda_is_a_candidate_only_on_a_card():
    s = _shape()
    cpu = {p.backend for p in candidate_plans(s)}
    assert cpu == {"fused", "looped"}
    card = candidate_plans(s, platform="cuda")
    assert {p.backend for p in card} == {"fused", "looped", "cuda"}
    # cuda and looped compact exactly: one compacted variant each; fused
    # sweeps the ladder floors
    assert sum(p.backend == "cuda" and p.compact for p in card) == 1
    assert sum(p.backend == "fused" and p.compact for p in card) == \
        len(costmodel.COMPACT_FLOOR_CANDIDATES)
    with pytest.raises(ValueError, match="no plan"):
        choose_plan(s, backends=("cuda",))
    with pytest.raises(ValueError, match="unknown backend"):
        candidate_plans(s, backends=("pallas",))
    assert choose_plan(s, backends=("cuda",),
                       platform="cuda").backend == "cuda"


def test_default_coefficients_rows():
    """A row a platform, none of the JAX package's: ``cpu`` has the plain
    walk and the loop, ``cuda`` every backend; every weight non-negative
    and finite, and each row routes a large batch to a non-looped walk."""
    assert set(costmodel.DEFAULT_COEFFS) == {"cpu", "cuda"}
    assert set(costmodel.DEFAULT_COEFFS["cpu"]) == {"fused", "looped"}
    assert set(costmodel.DEFAULT_COEFFS["cuda"]) == {"fused", "looped",
                                                     "cuda"}
    for row in costmodel.DEFAULT_COEFFS.values():
        for c in row.values():
            v = c.vector()
            assert np.isfinite(v).all() and (v >= 0).all() and v.any()
    with pytest.raises(ValueError, match="no cpu coefficients"):
        costmodel.default_coefficients("cuda", "cpu")
    big = _shape(B=1 << 20, W=65)
    assert choose_plan(big).backend == "fused"
    assert choose_plan(big, platform="cuda").backend == "cuda"


def test_get_backend_matrix():
    assert get_backend("auto", device="cpu").name == "fused"
    assert get_backend("auto", device="cuda").name == "cuda"
    assert get_backend("looped", device="cpu").name == "looped"
    assert get_backend("auto", shape=_shape(B=1 << 20, W=65),
                       device="cpu").name == "fused"
    with pytest.raises(ValueError, match="shape-dependent"):
        get_backend("tuned")
    with pytest.raises(ValueError, match="CUDA device"):
        get_backend("cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        get_backend("pallas", device="cpu")
    for name in ("fused", "looped", "cuda"):
        assert backend_for_plan(Plan(backend=name)).name == name


def test_calibrate_on_cpu_fits_both_backends():
    ds = make_dataset("d2", n_flows=400, seed=2)
    pdt = train_partitioned_dt(window_features(ds, 3, device="cpu"),
                               ds.labels, partition_sizes=[2, 2, 2], k=3)
    eng = Engine.from_model(pdt, device="cpu")
    coeffs = calibrate(eng, window_packets(ds, 3), probe_sizes=(32, 128),
                       repeat=1)
    assert set(coeffs) == {"fused", "looped"}
    for c in coeffs.values():
        v = c.vector()
        assert (v >= 0).all() and v.any()
    # terms no probe exercised keep the platform's default
    assert coeffs["fused"].perm == costmodel.DEFAULT_COEFFS["cpu"][
        "fused"].perm


# ---------------------------------------------------------------------------
# the autotune cache
# ---------------------------------------------------------------------------
def test_cache_round_trip(tune_cache):
    entries = {"k1": {"backend": "fused", "compact": False,
                      "compact_floor": 128, "us": 12.5}}
    save_cache(entries, tune_cache)
    assert load_cache(tune_cache) == entries
    with open(tune_cache, "w") as f:
        f.write("{not json")
    assert load_cache(tune_cache) == {}
    with open(tune_cache, "w") as f:
        json.dump({"version": 999, "entries": entries}, f)
    assert load_cache(tune_cache) == {}
    assert load_cache(str(tune_cache) + ".does-not-exist") == {}


def test_cache_key_holds_device_and_shape(jx):
    k1 = cache_key(_shape(B=256))
    assert k1 != cache_key(_shape(B=512))
    assert device_fingerprint() in k1
    assert device_fingerprint() == f"torch-cpu:cpu{os.cpu_count()}"
    assert cache_key(_shape(B=256), streaming=True) != k1
    assert len({cache_key(_shape(B=256), compact=c)
                for c in ("auto", True, False)}) == 3
    assert cache_key(_shape(B=256), backends=("fused",)) != k1
    # the JAX package's fingerprint names its platform, never "torch-"
    assert not jx.t.device_fingerprint().startswith("torch-")


def test_foreign_entries_are_retuned(jx, tune_cache):
    """An entry naming a backend the port lacks (a JAX ``pallas`` plan
    under the same key) is ignored and the shape is tuned again."""
    shape = ShapeInfo.from_engine(jx.port, jx.wp)
    key = cache_key(shape, compact=False, backends=("fused",))
    save_cache({key: {"backend": "pallas", "block_b": 64, "compact": False,
                      "compact_floor": 128, "us": 1.0}}, tune_cache)
    plan = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                    repeat=1, probe_flows=64)
    assert plan.source == "timed" and plan.backend == "fused"
    assert load_cache(tune_cache)[key]["backend"] == "fused"


def test_cached_auto_plan_does_not_override_pinned_compact(jx, tune_cache):
    free = autotune(jx.port, jx.wp, backends=("fused",), compact="auto",
                    repeat=1, probe_flows=64)
    assert free.source == "timed"
    pinned = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                      repeat=1, probe_flows=64)
    assert pinned.source == "timed" and pinned.compact is False
    assert autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                    repeat=1).source == "cache"
    res = jx.port.run(jx.wp, with_trace=False,
                      options=EngineOptions(impl="tuned", compact=False))
    assert res.plan.compact is False


def test_autotune_times_caches_and_rehits(jx, tune_cache):
    plan = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                    repeat=1, probe_flows=64)
    assert plan.backend == "fused" and plan.source == "timed"
    assert os.path.exists(tune_cache)
    again = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                     repeat=1)
    assert again.source == "cache" and again.backend == "fused"
    forced = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                      repeat=1, probe_flows=64, force=True)
    assert forced.source == "timed"


def test_autotune_no_timing_falls_back_to_costmodel(jx, tune_cache,
                                                    monkeypatch):
    monkeypatch.setenv(NO_TIME_ENV, "1")
    plan = autotune(jx.port, jx.wp)
    assert plan.source == "costmodel"
    assert not os.path.exists(tune_cache)


def test_unwritable_cache_never_raises(jx, tmp_path, monkeypatch):
    """A cache path that cannot be written (its directory is a file): the
    tuner still returns its timed winner, and later calls in the process
    are served from the in-process memo."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    monkeypatch.setenv(CACHE_ENV, str(blocker / "autotune.json"))
    plan = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                    repeat=1, probe_flows=64)
    assert plan.source == "timed"
    again = autotune(jx.port, jx.wp, backends=("fused",), compact=False,
                     repeat=1)
    assert again.source == "cache" and again.backend == plan.backend


def test_get_plan_forced_and_errors(jx):
    shape = ShapeInfo.from_engine(jx.port, jx.wp)
    plan = get_plan(jx.port, jx.wp, impl="looped")
    assert plan.backend == "looped" and plan.source == "forced"
    assert plan.est_us > 0
    auto = get_plan(jx.port, jx.wp, impl="fused", compact="auto")
    assert auto.backend == "fused" and auto.source == "forced"
    with pytest.raises(ValueError, match="CUDA device"):
        get_plan(jx.port, jx.wp, impl="cuda")
    with pytest.raises(ValueError, match="not allowed"):
        get_plan(jx.port, jx.wp, impl="looped", backends=("fused",))
    with pytest.raises(ValueError, match="unknown impl"):
        get_plan(jx.port, jx.wp, impl="pallas")
    with pytest.raises(ValueError, match="need win_pkts"):
        get_plan(jx.port, impl="auto")
    # tuned without windows: the cost model
    assert get_plan(jx.port, impl="tuned",
                    shape=shape).source == "costmodel"


# ---------------------------------------------------------------------------
# routing never changes bits
# ---------------------------------------------------------------------------
def _assert_identical(a, b):
    for name in ("labels", "recircs", "exit_partition"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_auto_impl_bit_identical_and_emits_plan(jx):
    auto = jx.port.run(jx.wp, options=EngineOptions(impl="auto"))
    assert auto.plan is not None and auto.plan.source == "costmodel"
    forced = jx.port.run(jx.wp, options=EngineOptions(
        impl=auto.plan.backend))
    assert forced.plan is None
    _assert_identical(auto, forced)
    for a, b in zip(auto.regs_trace, forced.regs_trace):
        np.testing.assert_array_equal(a, b)
    for got, want in zip((auto.labels, auto.recircs, auto.exit_partition),
                         jx.pdt.predict(jx.Xw, return_trace=True)):
        np.testing.assert_array_equal(got, want)
    _assert_identical(auto, jx.eng.run(jx.wp, options=jx.Options(
        impl="auto")))


def test_tuned_impl_bit_identical_to_routed_backend(jx, tune_cache):
    tuned = jx.port.run(jx.wp, with_trace=False,
                        options=EngineOptions(impl="tuned"))
    assert tuned.plan is not None and tuned.plan.source == "timed"
    again = jx.port.run(jx.wp, with_trace=False,
                        options=EngineOptions(impl="tuned"))
    assert again.plan.source == "cache"
    assert again.plan.backend == tuned.plan.backend
    forced = backend_for_plan(again.plan).run(
        jx.port, jx.wp, with_trace=False, options=EngineOptions(
            compact=again.plan.compact,
            compact_floor=again.plan.compact_floor))
    _assert_identical(again, forced)
    _assert_identical(again, tuned)


@pytest.mark.parametrize("impl", [None, "fused", "looped"])
def test_compact_auto_resolves_via_plan(jx, impl):
    res = jx.port.run(jx.wp, with_trace=False, options=EngineOptions(
        impl=impl, compact="auto"))
    assert res.plan is not None and res.plan.backend == (impl or "fused")
    _assert_identical(res, jx.port.run(jx.wp, with_trace=False))


def test_compact_auto_picks_compaction_for_front_loaded_exits():
    """With a survivor profile that exits most flows at hop 0 the model
    weighs compaction in; routed either way, the verdicts equal the dense
    walk's and the oracle's."""
    ds = make_profile_dataset("front", n_flows=600, seed=4)
    Xw = window_features(ds, 3, device="cpu")
    pdt = train_partitioned_dt(Xw, ds.labels, partition_sizes=[2, 2, 2],
                               k=3)
    eng = Engine.from_model(pdt, device="cpu")
    wp = window_packets(ds, 3)
    dense = eng.run(wp, with_trace=False)
    shape = ShapeInfo.from_engine(eng, wp, survivors=(1.0, 0.02, 0.01))
    plan = choose_plan(shape, backends=("fused",), compact="auto")
    assert plan.compact
    res = eng.run(wp, with_trace=False, options=EngineOptions(plan=plan))
    assert res.plan is plan
    _assert_identical(res, dense)
    for got, want in zip((res.labels, res.recircs, res.exit_partition),
                         pdt.predict(Xw, return_trace=True)):
        np.testing.assert_array_equal(got, want)


def test_streaming_auto_and_tuned_parity(jx, tune_cache):
    full = jx.port.run(jx.wp, with_trace=False)
    auto = run_streaming(jx.port, jx.wp, options=EngineOptions(
        micro_batch=96, impl="auto"))
    assert auto.plan is not None and auto.plan.backend == "fused"
    _assert_identical(auto, full)
    tuned = run_streaming(jx.port, jx.wp, options=EngineOptions(
        micro_batch=96, impl="tuned"))
    assert tuned.plan is not None and tuned.plan.backend == "fused"
    _assert_identical(tuned, full)
    key = cache_key(ShapeInfo.from_engine(jx.port, jx.wp, B=96),
                    streaming=True, compact=False, backends=("fused",))
    assert key in load_cache(tune_cache)
    both = run_streaming(jx.port, jx.wp, options=EngineOptions(
        micro_batch=96, compact="auto"))
    assert both.plan is not None
    _assert_identical(both, full)
    assert run_streaming(jx.port, jx.wp, options=EngineOptions(
        micro_batch=96, impl="fused")).plan is None


@pytest.mark.parametrize("floor", [16, 32, 256])
def test_compact_floor_bit_identical(jx, floor):
    dense = jx.port.run(jx.wp)
    plan = Plan(backend="fused", compact=True, compact_floor=floor)
    res = jx.port.run(jx.wp, options=EngineOptions(plan=plan))
    _assert_identical(res, dense)


# ---------------------------------------------------------------------------
# the server's routes
# ---------------------------------------------------------------------------
def test_tick_engine_auto_serves_like_jax(jx):
    """``tick_engine="auto"`` (the default in both packages) on a table
    that spills, with a timeout: every call's verdicts, the stats and the
    server registry equal the JAX server's."""
    from repro.flows.synthetic import make_packet_stream as j_make_stream
    from repro.serve import FlowTableServer as JServer
    from repro_torch.flows.synthetic import make_packet_stream
    knobs = dict(n_buckets=4, bucket_size=8, timeout=0.005)
    jsrv = JServer(jx.eng, options=jx.Options(impl="fused"), **knobs)
    srv = FlowTableServer(jx.port, **knobs)
    assert srv.tick_engine == jsrv.tick_engine == "fused"
    want = [jsrv.ingest(b)
            for b in j_make_stream(jx.tr, seed=11).ticks(1500)]
    want.append(jsrv.flush())
    got = [srv.ingest(b)
           for b in make_packet_stream(jx.tr, seed=11).ticks(1500)]
    got.append(srv.flush())
    assert srv.stats.spilled > 0 and srv.stats.evicted > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("flow_id", "labels", "recircs", "exit_partition"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name))
    assert srv.stats.as_dict() == jsrv.stats.as_dict()
    strip = lambda snap: {k: {n: {a: b for a, b in m.items() if a != "help"}
                              for n, m in v.items()}
                          for k, v in snap.items()}
    assert strip(srv.registry.snapshot()) == strip(jsrv.registry.snapshot())
    assert StreamVerdicts.concat(got).n_flows == jx.tr.n_flows


@pytest.mark.parametrize("impl", ["auto", "tuned"])
def test_server_routes_through_a_plan(jx, impl):
    srv = FlowTableServer(jx.port, options=EngineOptions(impl=impl))
    assert srv._plan is not None and srv._plan.backend == "fused"
    assert not srv._cuda and srv.tick_engine == "fused"
    srv = FlowTableServer(jx.port, options=EngineOptions(
        plan=Plan(backend="fused")), tick_engine="legacy")
    assert srv.tick_engine == "legacy"
    with pytest.raises(ValueError, match="walk backend"):
        FlowTableServer(jx.port, options=EngineOptions(impl="looped"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hop kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_tuned_plan_on_card_is_bit_identical(card, tune_cache):
    """On a CUDA engine ``auto`` and ``tuned`` (timed on the card, then a
    cache hit) give the CPU walk's verdicts, on ``Engine.run`` and on
    ``run_streaming``; the key names the card."""
    ds = make_dataset("d2", n_flows=3000, seed=3)
    pdt = train_partitioned_dt(window_features(ds, 3, device="cpu"),
                               ds.labels, partition_sizes=[2, 3, 2], k=4)
    wp = window_packets(ds, 3)
    cpu = Engine.from_model(pdt, device="cpu").run(wp, with_trace=False)
    eng = Engine.from_model(pdt, device=card)
    for impl in ("auto", "tuned", "tuned"):
        for compact in (False, "auto"):
            opt = EngineOptions(impl=impl, compact=compact)
            res = eng.run(wp, with_trace=False, options=opt)
            assert res.plan is not None
            _assert_identical(res, cpu)
            res = run_streaming(eng, wp, options=opt.replace(
                micro_batch=512))
            _assert_identical(res, cpu)
    assert any(k.startswith("torch-cuda:") for k in load_cache(tune_cache))
    assert device_fingerprint(card).startswith("torch-cuda:")
