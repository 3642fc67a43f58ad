"""The paper's evaluation path on the port, against the JAX package.

First the API the paper's claims read, name by name, at zero tolerance
on the same seeded inputs: ``full_flow_features`` (d1 and d2),
``quantize_features`` (4, 8, 16 and 32 bits), the model's structure
queries (``total_depth``, ``max_features_per_subtree``,
``feature_density``, ``SubTree.depth``) and ``Tree.predict_proba`` on
the same trained model, ``compute_all_features``, ``FEATURE_NAMES`` /
``NAME_TO_FID``, ``FlowTable.lookup`` / ``insert`` over a sequence that
overflows buckets and fills the table, the engine's default ``impl``
(``"ref"`` the alias of ``"fused"``) and the deprecated ``impl=`` /
``compact=`` keywords, which warn and refuse as JAX's do.

Then ``tests/test_system.py``'s five claims on the port at its sizes
(d1, 2,500 flows), each number equal to the JAX package's.

Last, the name parity: every public top-level name and class method of
a module of ``src/repro`` has a counterpart in the port's module of the
same path, but for the names of :data:`NOT_PORTED`, each with its
reason.  Both trees are parsed with ``ast``; neither is imported.
"""
import ast
import dataclasses
import pathlib
import warnings

import numpy as np
import pytest

# the JAX package is the reference; where it is not installed (the card's
# machine) these tests do not run
pytest.importorskip("jax")

from repro.core import features as JF  # noqa: E402
from repro.core.baselines import best_oneshot_for_flows as j_best_oneshot  # noqa: E402
from repro.core.inference import Engine as JEngine  # noqa: E402
from repro.core.partition import train_partitioned_dt as j_train  # noqa: E402
from repro.core.recirc import HADOOP as J_HADOOP  # noqa: E402
from repro.core.recirc import WEBSERVER as J_WEBSERVER  # noqa: E402
from repro.core.recirc import recirc_bandwidth as j_recirc_bandwidth  # noqa: E402
from repro.core.resources import estimate as j_estimate  # noqa: E402
from repro.core.tree import macro_f1 as j_macro_f1  # noqa: E402
from repro.flows import synthetic as j_synthetic  # noqa: E402
from repro.flows import windows as j_windows  # noqa: E402
from repro.serve.flowtable import FlowTable as JFlowTable  # noqa: E402
from repro_torch.core import features as F  # noqa: E402
from repro_torch.core.baselines import best_oneshot_for_flows  # noqa: E402
from repro_torch.core.inference import (  # noqa: E402
    Engine, EngineOptions, get_backend,
)
from repro_torch.core.partition import train_partitioned_dt  # noqa: E402
from repro_torch.core.recirc import HADOOP, WEBSERVER, recirc_bandwidth  # noqa: E402
from repro_torch.core.resources import estimate  # noqa: E402
from repro_torch.core.tree import macro_f1  # noqa: E402
from repro_torch.flows import synthetic  # noqa: E402
from repro_torch.flows import windows  # noqa: E402
from repro_torch.serve.flowtable import FlowTable  # noqa: E402

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _bits(a: np.ndarray, b: np.ndarray, what: str = "") -> None:
    """Equal dtype, shape and bits (f32 compared as int32: -0.0 and NaN
    payloads count)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same(a, b, what=""):
    """Equal plain data: dataclasses field by field, arrays to the bit,
    the rest with ``==``."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        _bits(a, b, what)
    else:
        assert a == b, what


# ---------------------------------------------------------------------------
# the data of tests/test_system.py, on both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def d1():
    """``make_dataset("d1", 2500)`` split on both packages, and each
    package's own window (P = 2, 3) and full-flow features."""
    ds, ds_j = synthetic.make_dataset("d1", n_flows=2500), \
        j_synthetic.make_dataset("d1", n_flows=2500)
    (tr, te), (tr_j, te_j) = ds.split(), ds_j.split()
    port = {"C": ds.n_classes, "tr": tr, "te": te}
    jax = {"C": ds_j.n_classes, "tr": tr_j, "te": te_j}
    for split in ("tr", "te"):
        for P in (2, 3):
            port[f"Xw{P}_{split}"] = windows.window_features(
                port[split], P, device=CPU)
            jax[f"Xw{P}_{split}"] = j_windows.window_features(jax[split], P)
        port[f"Xf_{split}"] = windows.full_flow_features(port[split],
                                                         device=CPU)
        jax[f"Xf_{split}"] = j_windows.full_flow_features(jax[split])
    return port, jax


# ---------------------------------------------------------------------------
# the names, one by one
# ---------------------------------------------------------------------------
def test_d1_windows_and_full_flow_features_equal_jax(d1):
    port, jax = d1
    for key in ("Xw2_tr", "Xw2_te", "Xw3_tr", "Xw3_te", "Xf_tr", "Xf_te"):
        _bits(port[key], jax[key], key)
    assert port["Xf_tr"].shape == (port["tr"].n_flows, F.N_FEATURES)


def test_full_flow_features_d2_equal_jax():
    ds = synthetic.make_dataset("d2", n_flows=700, seed=5)
    ds_j = j_synthetic.make_dataset("d2", n_flows=700, seed=5)
    got = windows.full_flow_features(ds, device=CPU)
    _bits(got, j_windows.full_flow_features(ds_j), "d2 full flow")
    _bits(got, windows.window_features(ds, 1, device=CPU)[:, 0, :])
    # the whole flow is one window: the registry's numpy oracle agrees
    # where it is exact (counts)
    allf = F.compute_all_features(windows.window_packets(ds, 1)[:, 0])
    count = [s.fid for s in F.REGISTRY if s.op == F.OP_COUNT]
    _bits(got[:, count], allf[:, count], "counts")


def test_flows_package_reexports():
    import repro.flows as jflows
    import repro_torch.flows as tflows
    for name in ("FlowDataset", "make_dataset", "window_features",
                 "full_flow_features"):
        assert hasattr(jflows, name) and hasattr(tflows, name), name
    assert tflows.full_flow_features is windows.full_flow_features


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_quantize_features_equal_jax(d1, bits):
    port, jax = d1
    for key in ("Xw2_tr", "Xf_te"):
        got = windows.quantize_features(port[key], bits)
        _bits(got, j_windows.quantize_features(jax[key], bits),
              f"{key} at {bits} bits")
    if bits >= 32:
        assert windows.quantize_features(port["Xw2_tr"], bits) \
            is port["Xw2_tr"]


def test_structure_queries_and_predict_proba_equal_jax(d1):
    port, jax = d1
    pdt = train_partitioned_dt(port["Xw3_tr"], port["tr"].labels,
                               partition_sizes=[3, 2, 2], k=4)
    pdt_j = j_train(jax["Xw3_tr"], jax["tr"].labels,
                    partition_sizes=[3, 2, 2], k=4)
    assert pdt.total_depth == pdt_j.total_depth == 7
    assert isinstance(pdt.total_depth, int)
    assert pdt.max_features_per_subtree() == pdt_j.max_features_per_subtree()
    assert pdt.feature_density() == pdt_j.feature_density()
    assert [s.depth for s in pdt.subtrees] == [s.depth for s in pdt_j.subtrees]
    for st, st_j in zip(pdt.subtrees, pdt_j.subtrees):
        X = port["Xw3_te"][:, st.partition]
        _bits(st.tree.predict_proba(X),
              st_j.tree.predict_proba(jax["Xw3_te"][:, st.partition]),
              f"predict_proba of subtree {st.sid}")
        # f32 class counts: each row sums to 1 within f32 rounding
        np.testing.assert_allclose(st.tree.predict_proba(X).sum(1), 1.0,
                                   rtol=1e-6)


def test_compute_all_features_and_names_equal_jax():
    rng = np.random.default_rng(11)
    pk = np.zeros((40, 3, 17, F.PKT_NFIELDS), np.float32)
    pk[..., F.PKT_TS] = np.cumsum(rng.random((40, 3, 17)), -1)
    pk[..., F.PKT_SIZE] = rng.integers(40, 1500, (40, 3, 17))
    pk[..., F.PKT_DIR] = rng.integers(0, 2, (40, 3, 17))
    pk[..., F.PKT_FLAGS] = rng.integers(0, 64, (40, 3, 17))
    pk[..., F.PKT_IAT] = rng.random((40, 3, 17))
    pk[..., F.PKT_VALID] = rng.random((40, 3, 17)) < 0.8
    got = F.compute_all_features(pk)
    assert got.shape == (40, 3, F.N_FEATURES)
    _bits(got, JF.compute_all_features(pk))
    assert F.FEATURE_NAMES == JF.FEATURE_NAMES
    assert F.NAME_TO_FID == JF.NAME_TO_FID
    assert [F.NAME_TO_FID[n] for n in F.FEATURE_NAMES] \
        == list(range(F.N_FEATURES))


def test_flowtable_single_key_api_equals_jax():
    """``insert`` / ``lookup`` / ``free`` interleaved over keys that
    collide, overflow their buckets and fill the table: every return,
    the key array and ``probe_overflows`` equal JAX's; the batch form
    shares the same probing."""
    t, t_j = FlowTable(8, 2), JFlowTable(8, 2)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 40, 40).tolist() + [7, 7 + 8, 7 + 16]
    live = []
    for step, key in enumerate(keys):
        assert t.lookup(key) == t_j.lookup(key)
        got, want = t.insert(key), t_j.insert(key)
        assert got == want, step
        if got is not None:
            live.append(got)
        if step % 7 == 6 and live:
            slot = live.pop(int(rng.integers(len(live))))
            t.free(slot)
            t_j.free(slot)
        assert t.lookup(key) == t_j.lookup(key)
        assert t.probe_overflows == t_j.probe_overflows
        _bits(t.key, t_j.key, f"keys after step {step}")
    assert t.resident == t_j.resident == t.capacity   # full: later inserts
    assert t.insert(12345) is None and t_j.insert(12345) is None
    assert t.lookup(12345) is None
    assert t.probe_overflows > 0
    # the batch form probes the same way
    b, b_j = FlowTable(8, 2), JFlowTable(8, 2)
    _bits(b.insert_batch(np.asarray(keys)), b_j.insert_batch(
        np.asarray(keys)))
    assert b.probe_overflows == b_j.probe_overflows
    _bits(b.lookup_batch(np.asarray(keys)),
          b_j.lookup_batch(np.asarray(keys)))


@pytest.fixture(scope="module")
def engines(d1):
    port, jax = d1
    pdt = train_partitioned_dt(port["Xw3_tr"], port["tr"].labels,
                               partition_sizes=[3, 3, 3], k=4)
    pdt_j = j_train(jax["Xw3_tr"], jax["tr"].labels,
                    partition_sizes=[3, 3, 3], k=4)
    wp = windows.window_packets(port["te"], 3)
    return pdt, pdt_j, wp


def _verdicts(res):
    return (res.labels, res.recircs, res.exit_partition, *res.regs_trace)


def test_engine_impl_ref_equals_jax(engines):
    pdt, pdt_j, wp = engines
    eng = Engine.from_model(pdt, impl="ref", device=CPU)
    assert eng.impl == "ref"
    got = eng.run(wp)
    want = JEngine.from_model(pdt_j, impl="ref").run(wp)
    for i, (a, b) in enumerate(zip(_verdicts(got), _verdicts(want))):
        _bits(a, b, f"verdict field {i}")
    assert got.plan is None
    assert get_backend("ref", device=CPU) is get_backend("fused", device=CPU)
    # the engine's impl is the fallback of options.impl
    fused = Engine.from_model(pdt, device=CPU).run(
        wp, options=EngineOptions(impl="ref"))
    for a, b in zip(_verdicts(got), _verdicts(fused)):
        _bits(a, b)


def test_engine_default_impl_routes_as_jax(engines):
    pdt, _, wp = engines
    # no keyword: the device's route, no plan (as before the field)
    assert Engine.from_model(pdt, device=CPU).run(wp).plan is None
    # an engine-level "auto" routes through the cost model, as JAX's
    auto = Engine.from_model(pdt, impl="auto", device=CPU)
    res = auto.run(wp)
    assert res.plan is not None and res.plan.source == "costmodel"
    # ... unless the call names its own backend
    assert auto.run(wp, options=EngineOptions(impl="fused")).plan is None
    assert auto.run_streaming(wp).plan is not None
    with pytest.raises(ValueError, match="unknown impl"):
        Engine.from_model(pdt, impl="pallas", device=CPU)
    # an engine-level "looped" takes the looped route on every entry
    looped = Engine.from_model(pdt, impl="looped", device=CPU)
    for a, b in zip(_verdicts(looped.run(wp)), _verdicts(res)):
        _bits(a, b)
    with pytest.raises(ValueError, match="walk backend"):
        looped.run_streaming(wp)


def test_legacy_keywords_warn_and_refuse_as_jax(engines):
    pdt, pdt_j, wp = engines
    eng = Engine.from_model(pdt, device=CPU)
    eng_j = JEngine.from_model(pdt_j)
    new = eng.run(wp, options=EngineOptions(impl="fused", compact=True))
    with pytest.warns(DeprecationWarning, match="impl"):
        # splint: allow[R005]: exercises the deprecation shim on purpose
        legacy = eng.run(wp, impl="fused", compact=True)
    for a, b in zip(_verdicts(legacy), _verdicts(new)):
        _bits(a, b)
    with pytest.warns(DeprecationWarning, match="compact"):
        # splint: allow[R005]: exercises the deprecation shim on purpose
        looped = eng.run_looped(wp, compact=True)
    with pytest.warns(DeprecationWarning, match="micro_batch"):
        # splint: allow[R005]: exercises the deprecation shim on purpose
        streamed = eng.run_streaming(wp, micro_batch=64, inflight=1)
    for res in (looped, streamed):
        for a, b in zip(_verdicts(res)[:3], _verdicts(new)[:3]):
            _bits(a, b)
    # the JAX package warns with the same message
    with pytest.warns(DeprecationWarning) as rec:
        # splint: allow[R005]: exercises the deprecation shim on purpose
        eng.run(wp, impl="ref")
    with pytest.warns(DeprecationWarning) as rec_j:
        # splint: allow[R005]: exercises the deprecation shim on purpose
        eng_j.run(wp, impl="ref")
    assert str(rec[0].message) == str(rec_j[0].message)
    # mixing the keywords with options= is refused, as by JAX's
    for engine in (eng, eng_j):
        with pytest.raises(ValueError, match="not both"):
            # splint: allow[R005]: exercises the deprecation shim on purpose
            engine.run(wp, options=_options_of(engine)(), impl="fused")
        with pytest.raises(ValueError, match="not both"):
            # splint: allow[R005]: exercises the deprecation shim on purpose
            engine.run_looped(wp, options=_options_of(engine)(),
                              compact=True)
        with pytest.raises(ValueError, match="not both"):
            # splint: allow[R005]: exercises the deprecation shim on purpose
            engine.run_streaming(wp, options=_options_of(engine)(),
                                 micro_batch=64)
    # the options path is silent
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        eng.run(wp, options=EngineOptions(impl="ref"))


def _options_of(engine):
    if isinstance(engine, Engine):
        return EngineOptions
    from repro.core.inference import EngineOptions as JOptions
    return JOptions


# ---------------------------------------------------------------------------
# tests/test_system.py's claims on the port, equal to JAX's
# ---------------------------------------------------------------------------
def test_splidt_beats_topk_baseline_as_jax(d1):
    port, jax = d1
    C = port["C"]
    pdt = train_partitioned_dt(port["Xw2_tr"], port["tr"].labels,
                               partition_sizes=[6, 6], k=6)
    pdt_j = j_train(jax["Xw2_tr"], jax["tr"].labels,
                    partition_sizes=[6, 6], k=6)
    f1 = macro_f1(port["te"].labels, pdt.predict(port["Xw2_te"]), C)
    f1_j = j_macro_f1(jax["te"].labels, pdt_j.predict(jax["Xw2_te"]), C)
    kw = dict(flows=100_000, style="nb", n_classes=C, k_grid=(6,),
              depth_grid=(13,))
    _, f1_topk = best_oneshot_for_flows(port["Xf_tr"], port["tr"].labels,
                                        port["Xf_te"], port["te"].labels,
                                        **kw)
    _, f1_topk_j = j_best_oneshot(jax["Xf_tr"], jax["tr"].labels,
                                  jax["Xf_te"], jax["te"].labels, **kw)
    assert (f1, f1_topk) == (f1_j, f1_topk_j)
    assert f1 > f1_topk, (f1, f1_topk)


def test_5x_feature_scaling_at_same_registers_as_jax(d1):
    port, jax = d1
    pdt = train_partitioned_dt(port["Xw3_tr"], port["tr"].labels,
                               partition_sizes=[5, 5, 5], k=6)
    pdt_j = j_train(jax["Xw3_tr"], jax["tr"].labels,
                    partition_sizes=[5, 5, 5], k=6)
    total = len(pdt.unique_features())
    _bits(pdt.unique_features(), pdt_j.unique_features())
    assert total >= 5 * 6 * 0.8
    assert pdt.max_features_per_subtree() \
        == pdt_j.max_features_per_subtree() <= 6


def test_full_stack_engine_pipeline_as_jax(d1, engines):
    port, jax = d1
    pdt, pdt_j, wp = engines
    res = Engine.from_model(pdt, impl="ref", device=CPU).run(wp)
    res_j = JEngine.from_model(pdt_j, impl="ref").run(wp)
    C = port["C"]
    f1 = macro_f1(port["te"].labels, res.labels, C)
    assert f1 == j_macro_f1(jax["te"].labels, res_j.labels, C)
    assert f1 > 0.4
    for env, env_j in ((WEBSERVER, J_WEBSERVER), (HADOOP, J_HADOOP)):
        bw = recirc_bandwidth(res.recircs, 1_000_000, env)
        _same(bw, j_recirc_bandwidth(res_j.recircs, 1_000_000, env_j),
              env.name)
        assert bw.fraction_of_budget < 5e-4          # paper: <0.05%
    rep = estimate(pdt, flows=100_000)
    _same(rep, j_estimate(pdt_j, flows=100_000), "estimate")
    assert rep.feasible, rep.reasons


def test_bit_precision_tradeoff_as_jax(d1):
    port, jax = d1
    C = port["C"]
    out = {}
    for name, d, train, f1_of, est in (
            ("port", port, train_partitioned_dt, macro_f1, estimate),
            ("jax", jax, j_train, j_macro_f1, j_estimate)):
        q = windows.quantize_features if name == "port" \
            else j_windows.quantize_features
        pdt32 = train(d["Xw2_tr"], d["tr"].labels, partition_sizes=[5, 5],
                      k=4)
        f32 = f1_of(d["te"].labels, pdt32.predict(d["Xw2_te"]), C)
        pdt8 = train(q(d["Xw2_tr"], 8), d["tr"].labels,
                     partition_sizes=[5, 5], k=4)
        f8 = f1_of(d["te"].labels, pdt8.predict(q(d["Xw2_te"], 8)), C)
        out[name] = (f32, f8, est(pdt32, bits=32), est(pdt8, bits=8))
    _same(out["port"], out["jax"], "f32, f8, reports")
    f32, f8, r32, r8 = out["port"]
    assert f8 > 0.5 * f32
    assert r8.flow_capacity > 2 * r32.flow_capacity


def test_register_footprint_constant_in_features_as_jax(d1):
    port, jax = d1
    reg_bits, totals = [], []
    for ps in ([2, 2, 2], [5, 5, 5]):
        pdt = train_partitioned_dt(port["Xw3_tr"], port["tr"].labels,
                                   partition_sizes=ps, k=4)
        pdt_j = j_train(jax["Xw3_tr"], jax["tr"].labels,
                        partition_sizes=ps, k=4)
        _same(estimate(pdt), j_estimate(pdt_j), f"estimate {ps}")
        reg_bits.append(estimate(pdt).register_bits_per_flow)
        totals.append(len(pdt.unique_features()))
    assert totals[1] > totals[0]
    assert abs(reg_bits[1] - reg_bits[0]) <= 32


# ---------------------------------------------------------------------------
# name parity
# ---------------------------------------------------------------------------
#: JAX names with no counterpart in the port's module of the same path,
#: each with its reason; a renamed counterpart is named in its reason.
NOT_PORTED = {
    "analysis/roofline.py": {
        "parse_collectives": "counterpart: CollectiveCounter, which counts "
                             "the sharded trace's collectives (the port "
                             "has no HLO text to parse)",
        "ICI_BW": "counterpart: LINK_BW (the H100's NVLink rate)",
    },
    "launch/dryrun.py": {
        "lower_compile": "replaced by trace_cell: one step counted on meta "
                         "(analysis.roofline.OpCounter)",
    },
    "models/layers.py": {
        "scan_layers": "the models loop over their layers in Python",
        "set_unroll": "no lax.scan to unroll",
    },
    "distributed/sharding.py": {
        "flow_batch_spec": "a shard_map spec; the streaming engine splits "
                           "rows with flow_shards over a FlowMesh",
    },
    "fit/batched.py": {
        "train_tree_jax": "counterpart: train_tree_torch",
    },
    "models/mamba2.py": {
        "mamba_mixer": "counterpart: MambaLayers",
    },
    "core/inference.py": {
        "Engine.dev": "counterpart: Engine.tables.dev",
        "ExecutionBackend": "counterpart: WalkBackend",
        "ExecutionBackend.run": "counterpart: WalkBackend.run",
        "PALLAS_BACKEND": "counterpart: the cuda backend (HOP_BACKEND)",
        "pallas_backend": "counterpart: the cuda backend; the port's "
                          "backends have no block_b",
    },
    "kernels/ops.py": {
        "fused_step_pallas": "counterpart: cuda_step",
        "pallas_step": "counterpart: cuda_step",
    },
    "kernels/feature_window.py": {
        "BLOCK_B": "the Pallas flow block; kernel A's CTA is "
                   "kernels/window.py's window_geometry",
    },
    "tuning/costmodel.py": {
        "BLOCK_B_CANDIDATES": "the port's backends have no block_b "
                              "(tuning/costmodel.py)",
    },
    "train/optimizer.py": {
        "TrainState.tree_flatten": "a JAX pytree registration",
        "TrainState.tree_unflatten": "a JAX pytree registration",
    },
}

#: The Pallas kernels (each ``pl.pallas_call`` site) and their block
#: constants: the port's Hopper kernel in the same module, which must
#: exist there.
KERNEL_COUNTERPARTS = {
    "kernels/feature_window.py": {
        "feature_window_pallas": "feature_window_kernel",
        "feature_update_pallas": "feature_update_kernel",
        "feature_update_finalize_pallas": "feature_update_finalize_kernel",
    },
    "kernels/dt_traverse.py": {"dt_traverse_pallas": "dt_traverse_kernel"},
    "kernels/chunk_scan.py": {"chunk_scan_pallas": "chunk_scan_kernel"},
}

#: JAX modules with no port module at all.
MODULES_NOT_PORTED = {
    "_jax_compat.py": "jax 0.4 shims",
    "testing/__init__.py": "a test helper package",
    "testing/hypothesis_compat.py": "a test helper, which the port's "
                                    "tests may import from repro",
}


def _public_names(path: pathlib.Path, *, imports: bool) -> set[str]:
    """Public top-level defs, classes, class methods and assigned names
    of a module; with ``imports`` also the names it imports (a re-export
    is a counterpart)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{b.name}" for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif imports and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names
            if not any(part.startswith("_") for part in n.split("."))}


def _name_gaps() -> dict[str, list[str]]:
    jax_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    gaps = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        port = port_root / rel
        if not port.exists():
            gaps[rel] = None
            continue
        missing = sorted(_public_names(path, imports=False)
                         - _public_names(port, imports=True))
        if missing:
            gaps[rel] = missing
    return gaps


def test_every_jax_name_has_a_counterpart_or_a_reason():
    gaps = _name_gaps()
    unexplained = {}
    for rel, missing in gaps.items():
        if missing is None:
            assert rel in MODULES_NOT_PORTED, f"{rel}: no port module"
            continue
        explained = set(NOT_PORTED.get(rel, {})) \
            | set(KERNEL_COUNTERPARTS.get(rel, {}))
        left = [n for n in missing if n not in explained]
        if left:
            unexplained[rel] = left
    assert not unexplained, f"JAX names with no port counterpart: " \
                            f"{unexplained}"


def test_not_ported_lists_only_real_gaps():
    """Each listed name is a public name of its JAX module that the port's
    module lacks, and each kernel counterpart exists in the port."""
    gaps = _name_gaps()
    for rel, names in NOT_PORTED.items():
        for name, reason in names.items():
            assert name in (gaps.get(rel) or ()), f"{rel}: {name} is ported"
            assert reason
    port_root = ROOT / "src" / "repro_torch"
    for rel, names in KERNEL_COUNTERPARTS.items():
        have = _public_names(port_root / rel, imports=True)
        for name, port_name in names.items():
            assert name in gaps[rel], f"{rel}: {name} is ported"
            assert port_name in have, f"{rel}: no {port_name}"
    for rel in MODULES_NOT_PORTED:
        assert (ROOT / "src" / "repro" / rel).exists()
        assert gaps.get(rel, 0) is None, f"{rel} has a port module"
