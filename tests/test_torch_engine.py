"""The port's main path vs the JAX package, at zero tolerance.

``make_dataset`` -> ``window_features`` -> ``train_partitioned_dt`` ->
packed tables -> ``Engine.run``, each step of the port held against the
same step of the JAX package on the same seeds.  The port runs on the
CPU (``device="cpu"``, the plain PyTorch step); the JAX engine runs its
``fused`` step and its Pallas step in interpret mode.  Verdicts and
register traces must be equal (docs/PARITY.md).
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference; where it is not installed (the card's
# machine) only test_torch_package.py runs
pytest.importorskip("jax")

from repro.core.inference import Engine as JEngine  # noqa: E402
from repro.core.inference import EngineOptions as JOptions  # noqa: E402
from repro.core.partition import train_partitioned_dt as j_train  # noqa: E402
from repro.core.range_tables import pack_range_exec as j_pack_range_exec  # noqa: E402
from repro.core.tables import pack_tables as j_pack_tables  # noqa: E402
from repro.flows.synthetic import make_dataset as j_make_dataset  # noqa: E402
from repro.flows.synthetic import make_profile_dataset as j_make_profile  # noqa: E402
from repro.flows.windows import window_features as j_window_features  # noqa: E402
from repro.flows.windows import window_packets as j_window_packets  # noqa: E402
from repro_torch.convert import engine_tables_from_arrays  # noqa: E402
from repro_torch.core.inference import Engine, EngineOptions  # noqa: E402
from repro_torch.core.partition import train_partitioned_dt  # noqa: E402
from repro_torch.core.range_tables import pack_range_exec  # noqa: E402
from repro_torch.core.tables import pack_tables  # noqa: E402
from repro_torch.flows.synthetic import make_dataset, make_profile_dataset  # noqa: E402
from repro_torch.flows.windows import window_features, window_packets  # noqa: E402

_PACKED = ("node_feat_slot", "node_thresh", "node_left", "node_right",
           "leaf_next_sid", "leaf_label", "slot_fid", "slot_op",
           "slot_field", "slot_pred", "slot_init", "sid_partition")
_RANGE = ("thresholds", "leaf_lo", "leaf_hi", "leaf_action", "leaf_valid")


def _assert_dataset_equal(a, b):
    for name in ("packets", "lengths", "labels"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.n_classes, a.name) == (b.n_classes, b.name)


@pytest.mark.parametrize("name,n,seed", [("d2", 300, None), ("d1", 120, 7),
                                         ("d3", 90, 3)])
def test_make_dataset_bit_for_bit(name, n, seed):
    a = make_dataset(name, n, seed=seed)
    b = j_make_dataset(name, n, seed=seed)
    _assert_dataset_equal(a, b)
    for x, y in zip(a.split(seed=1), b.split(seed=1)):
        _assert_dataset_equal(x, y)


@pytest.mark.parametrize("profile", ["front", "uniform", "back"])
def test_make_profile_dataset_bit_for_bit(profile):
    _assert_dataset_equal(make_profile_dataset(profile, 150, seed=2),
                          j_make_profile(profile, 150, seed=2))


@pytest.fixture(scope="module")
def port_model(trained_pdt):
    """The port's window features and model, from the same training
    split the JAX ``trained_pdt`` fixture used."""
    pdt_j, Xw_j, tr = trained_pdt
    Xw = window_features(tr, 3, device="cpu")
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[2, 3, 2], k=4)
    return pdt, Xw


def test_window_features_bit_for_bit(trained_pdt, port_model):
    _, Xw_j, tr = trained_pdt
    _, Xw = port_model
    assert Xw.dtype == np.float32 and Xw.shape == Xw_j.shape
    np.testing.assert_array_equal(Xw, Xw_j)
    np.testing.assert_array_equal(window_packets(tr, 3),
                                  j_window_packets(tr, 3))


def test_trained_tables_array_by_array(trained_pdt, port_model):
    pdt_j, _, _ = trained_pdt
    pdt, _ = port_model
    assert len(pdt.subtrees) == len(pdt_j.subtrees)
    a, b = pack_tables(pdt), j_pack_tables(pdt_j)
    for name in _PACKED:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.n_partitions, a.k, a.max_depth) == (b.n_partitions, b.k,
                                                   b.max_depth)
    a, b = pack_range_exec(pdt), j_pack_range_exec(pdt_j)
    for name in _RANGE:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.n_subtrees, a.n_classes) == (b.n_subtrees, b.n_classes)


def _assert_result_equal(res, ref, *, trace: bool = True):
    for name in ("labels", "recircs", "exit_partition"):
        got, want = getattr(res, name), getattr(ref, name)
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if trace:
        assert len(res.regs_trace) == len(ref.regs_trace)
        for p, (got, want) in enumerate(zip(res.regs_trace, ref.regs_trace)):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"regs hop {p}")


@pytest.fixture(scope="module")
def jax_results(trained_pdt, small_flow_ds):
    pdt_j, _, _ = trained_pdt
    _, te = small_flow_ds.split()
    wp = j_window_packets(te, 3)
    eng = JEngine.from_model(pdt_j)
    return wp, te, {impl: eng.run(wp, options=JOptions(impl=impl))
                    for impl in ("fused", "pallas")}


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_engine_run_cpu_matches_jax(port_model, jax_results, impl):
    pdt, _ = port_model
    wp, _, ref = jax_results
    res = Engine.from_model(pdt, device="cpu").run(wp)
    _assert_result_equal(res, ref[impl])


def test_engine_run_matches_numpy_oracle(port_model, jax_results):
    pdt, _ = port_model
    wp, te, _ = jax_results
    labels, recircs, exit_p = pdt.predict(window_features(te, 3,
                                                          device="cpu"),
                                          return_trace=True)
    res = Engine.from_model(pdt, device="cpu").run(
        torch.from_numpy(wp), with_trace=False,
        options=EngineOptions(impl="fused"))
    np.testing.assert_array_equal(res.labels, labels)
    np.testing.assert_array_equal(res.recircs, recircs)
    np.testing.assert_array_equal(res.exit_partition, exit_p)
    assert res.regs_trace == [] and res.n_unterminated == 0


def test_engine_from_jax_device_tables(trained_pdt, jax_results):
    """``convert`` carries the JAX engine's nine device arrays across:
    the port then runs the very same tables."""
    from repro.kernels.ops import device_tables
    pdt_j, _, _ = trained_pdt
    wp, _, ref = jax_results
    ret = j_pack_range_exec(pdt_j)
    jdev = device_tables(j_pack_tables(pdt_j), ret)
    arrays = {name: np.asarray(getattr(jdev, name)) for name in jdev._fields}
    tables = engine_tables_from_arrays(
        arrays, n_subtrees=ret.n_subtrees, n_partitions=pdt_j.n_partitions,
        n_classes=ret.n_classes, device="cpu")
    res = Engine.from_tables(tables).run(wp)
    _assert_result_equal(res, ref["pallas"])
    bad = dict(arrays, thresholds=arrays["thresholds"].astype(np.float64))
    with pytest.raises(ValueError, match="thresholds"):
        engine_tables_from_arrays(bad, n_subtrees=ret.n_subtrees,
                                  n_partitions=3, n_classes=4, device="cpu")


def _truncate(pdt):
    """Make the final partition route instead of exit (a depth-truncated
    DSE candidate's shape, as in tests/test_compaction.py)."""
    last = pdt.n_partitions - 1
    for st in pdt.subtrees:
        if st.partition == last:
            for leaf in st.leaf_next_sid:
                st.leaf_next_sid[leaf] = st.sid          # self-loop
    return pdt


def test_non_terminating_flows_report_sentinels():
    ds = make_dataset("d2", n_flows=300, seed=7)
    Xw = window_features(ds, 3, device="cpu")
    np.testing.assert_array_equal(
        Xw, j_window_features(j_make_dataset("d2", n_flows=300, seed=7), 3))
    pdt = _truncate(train_partitioned_dt(Xw, ds.labels,
                                         partition_sizes=[2, 2, 2], k=3))
    pdt_j = _truncate(j_train(Xw, ds.labels, partition_sizes=[2, 2, 2], k=3))
    labels, recircs, exit_p = pdt.predict(Xw, return_trace=True)
    stuck = labels == -1
    assert stuck.any() and not stuck.all()
    np.testing.assert_array_equal(exit_p[stuck], -1)
    wp = window_packets(ds, 3)
    res = Engine.from_model(pdt, device="cpu").run(wp, with_trace=False)
    np.testing.assert_array_equal(res.labels, labels)
    np.testing.assert_array_equal(res.exit_partition, exit_p)
    np.testing.assert_array_equal(res.recircs, recircs)
    assert res.n_unterminated == int(stuck.sum())
    ref = JEngine.from_model(pdt_j).run(wp, with_trace=False,
                                        options=JOptions(impl="fused"))
    _assert_result_equal(res, ref, trace=False)
    assert ref.n_unterminated == res.n_unterminated
