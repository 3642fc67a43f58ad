"""The port's design-space modules vs the JAX package's originals.

``core/{rangemark,mat,resources,recirc,baselines,dse}.py`` are numpy
copies; each is held to its original on the cases of
``tests/test_rangemark.py``, ``tests/test_mat_store.py``,
``tests/test_resources_dse.py`` and the baseline cases of
``tests/test_system.py``: equal values (floats to the bit), equal rule
tables, equal trees.  A seeded ``bayes_search`` gives the JAX package's
history, every ``Evaluation`` field, under ``trainer="numpy"``.  The
copies of ``max_dep_depth``, ``compute_feature``, ``feature_importance``
and ``Tree.predict`` that they read are held to theirs too.
"""
import dataclasses

import numpy as np
import pytest

# the JAX package is the reference; where it is not installed (the card's
# machine) these tests do not run
pytest.importorskip("jax")

from repro.core import baselines as j_baselines  # noqa: E402
from repro.core import dse as j_dse  # noqa: E402
from repro.core import features as JF  # noqa: E402
from repro.core import mat as j_mat  # noqa: E402
from repro.core import rangemark as j_rm  # noqa: E402
from repro.core import recirc as j_recirc  # noqa: E402
from repro.core import resources as j_res  # noqa: E402
from repro.core import tree as j_tree  # noqa: E402
from repro.flows.synthetic import make_dataset as j_make_dataset  # noqa: E402
from repro.flows.windows import (  # noqa: E402
    full_flow_features as j_full_flow_features,
)
from repro.testing.hypothesis_compat import (  # noqa: E402
    given, settings, strategies as st,
)
from repro_torch import obs  # noqa: E402
from repro_torch.core import baselines, dse, mat, rangemark, recirc  # noqa: E402
from repro_torch.core import features as F  # noqa: E402
from repro_torch.core import resources as res  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.core.partition import train_partitioned_dt  # noqa: E402
from repro_torch.flows.synthetic import make_dataset  # noqa: E402
from repro_torch.flows.windows import (  # noqa: E402
    full_flow_features, window_features,
)

_TREE = ("feature", "threshold", "left", "right", "value")


def _assert_same(a, b, what=""):
    """Equal plain data: dataclasses field by field, arrays and floats to
    the bit (NaN where NaN), everything else with ``==``."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for key in a:
            _assert_same(a[key], b[key], f"{what}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, (np.ndarray, float, np.floating)):
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, what
        np.testing.assert_array_equal(x, y, err_msg=what)
    else:
        assert a == b, what


def _assert_tree(t, t_j, what="tree"):
    for name in _TREE:
        _assert_same(getattr(t, name), getattr(t_j, name), f"{what}.{name}")


# ---------------------------------------------------------------------------
# the copies the design-space modules read
# ---------------------------------------------------------------------------
def test_feature_copies_equal_jax():
    rng = np.random.default_rng(3)
    for n in range(0, F.N_FEATURES + 1, 5):
        fids = rng.choice(F.N_FEATURES, n, replace=False)
        assert F.max_dep_depth(fids) == JF.max_dep_depth(fids)
    pk = np.zeros((32, 24, F.PKT_NFIELDS), np.float32)
    pk[..., F.PKT_TS] = np.cumsum(rng.random((32, 24)), axis=1)
    pk[..., F.PKT_SIZE] = rng.integers(40, 1500, (32, 24))
    pk[..., F.PKT_DIR] = rng.integers(0, 2, (32, 24))
    pk[..., F.PKT_FLAGS] = rng.integers(0, 64, (32, 24))
    pk[..., F.PKT_IAT] = rng.random((32, 24))
    pk[..., F.PKT_VALID] = rng.random((32, 24)) < 0.7
    for spec in F.REGISTRY:
        _assert_same(F.compute_feature(pk, spec),
                     JF.compute_feature(pk, JF.REGISTRY[spec.fid]),
                     spec.name)


def test_tree_copies_equal_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(400, 8)).astype(np.float32)
    y = ((X[:, 0] > 0).astype(int) + 2 * (X[:, 1] > 0)).astype(np.int64)
    t, t_j = tree.train_tree(X, y, max_depth=5), j_tree.train_tree(
        X, y, max_depth=5)
    _assert_tree(t, t_j)
    _assert_same(t.predict(X), t_j.predict(X), "predict")
    _assert_same(tree.feature_importance(X, y, max_depth=6),
                 j_tree.feature_importance(X, y, max_depth=6), "importance")


# ---------------------------------------------------------------------------
# rangemark (tests/test_rangemark.py)
# ---------------------------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(st.integers(0, 255), st.integers(0, 255), st.integers(1, 16))
def test_prefix_cover_equals_jax(a, b, width):
    lo, hi = min(a, b), max(a, b)
    assert rangemark.prefix_cover_count(lo, hi, width) == \
        j_rm.prefix_cover_count(lo, hi, width)


def test_quantize_thresholds_equals_jax():
    for thr, lo, hi, bits in (([0.5, 1.5, 7.2], 0.0, 10.0, 8),
                              ([-3.0, 0.0, 1e6], -5.0, 5.0, 16),
                              ([2.0], 2.0, 2.0, 32)):
        _assert_same(rangemark.quantize_thresholds(np.asarray(thr), lo, hi,
                                                   bits),
                     j_rm.quantize_thresholds(np.asarray(thr), lo, hi, bits))


def _rules_pair(X, y, depth, k, leaf_action, **kw):
    t = tree.train_tree(X, y, max_depth=depth, k_features=k)
    t_j = j_tree.train_tree(X, y, max_depth=depth, k_features=k)
    _assert_tree(t, t_j)
    act = leaf_action(t)
    return (rangemark.build_subtree_rules(t, act, **kw),
            j_rm.build_subtree_rules(t_j, act, **kw))


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 5))
def test_subtree_rules_equal_jax(seed, depth):
    """The rule tables, their entry and bit counts and their execution
    equal the original's, which equal the tree's traversal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    y = rng.integers(0, 3, 300)
    ranges = {f: (-3.0, 3.0) for f in range(0, 6, 2)}
    for kw in ({}, {"bits": 8, "feature_ranges": ranges, "sid_bits": 4}):
        r, r_j = _rules_pair(
            X, y, depth, 4,
            lambda t: {int(i): 100 + int(i)
                       for i in np.nonzero(t.feature < 0)[0]}, **kw)
        _assert_same(r, r_j, "rules")
        assert r.total_entries == r_j.total_entries
        assert r.tcam_bits() == r_j.tcam_bits()
        assert r.tcam_bits(sid_bits=4) == r_j.tcam_bits(sid_bits=4)
        _assert_same(r.apply(X), r_j.apply(X), "apply")


def test_key_bits_equal_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(400, 8)).astype(np.float32)
    y = ((X[:, 0] > 0).astype(int) + 2 * (X[:, 1] > 0)).astype(np.int64)
    zero = lambda t: {int(i): 0 for i in np.nonzero(t.feature < 0)[0]}
    for depth, k in ((2, 1), (6, 3)):
        r, r_j = _rules_pair(X, y, depth, k, zero)
        _assert_same(r, r_j, f"depth {depth}")


# ---------------------------------------------------------------------------
# mat and recirc (tests/test_mat_store.py)
# ---------------------------------------------------------------------------
def test_flow_store_equals_jax():
    ft = mat.random_five_tuples(2000, np.random.default_rng(0))
    _assert_same(ft, j_mat.random_five_tuples(2000,
                                              np.random.default_rng(0)))
    _assert_same(mat.crc32_hash(ft), j_mat.crc32_hash(ft), "crc32")
    stores = (mat.FlowStore(capacity=4096, k=4),
              j_mat.FlowStore(capacity=4096, k=4))
    h = mat.crc32_hash(ft[:1000])
    slots = [s.admit(np.arange(1000), h) for s in stores]
    _assert_same(slots[0], slots[1], "admit")
    _assert_same(stores[0].stats(), stores[1].stats(), "stats")
    for s, sl in zip(stores, slots):
        s.evict(sl)
    _assert_same(stores[0].stats(), stores[1].stats(), "stats after evict")
    slots = [s.admit(np.arange(1000, 2000), h) for s in stores]
    _assert_same(slots[0], slots[1], "re-admit")
    for name in ("slot_owner", "sid", "pkt_count", "regs"):
        _assert_same(getattr(stores[0], name), getattr(stores[1], name),
                     name)
    _assert_same(mat.collision_curve(1 << 12, [0.05, 0.3, 0.7]),
                 j_mat.collision_curve(1 << 12, [0.05, 0.3, 0.7]))


def test_time_to_detection_equals_jax():
    ds = make_dataset("d2", 300, seed=4)
    j_ds = j_make_dataset("d2", 300, seed=4)
    rng = np.random.default_rng(4)
    exit_p = rng.integers(-1, 3, ds.n_flows)           # -1: never exited
    got = recirc.time_to_detection(ds.packets, ds.lengths, exit_p, 3)
    _assert_same(got, j_recirc.time_to_detection(j_ds.packets, j_ds.lengths,
                                                 exit_p, 3))
    assert np.isnan(got[exit_p < 0]).all() and np.isfinite(
        got[exit_p >= 0]).all()


def test_recirc_bandwidth_equals_jax():
    t = np.random.default_rng(2).integers(0, 3, 5000)
    for env in ("WS", "HD"):
        for flows in (500_000, 1_000_000):
            _assert_same(
                recirc.recirc_bandwidth(t, flows, recirc.ENVIRONMENTS[env]),
                j_recirc.recirc_bandwidth(t, flows,
                                          j_recirc.ENVIRONMENTS[env]))


# ---------------------------------------------------------------------------
# resources (tests/test_resources_dse.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models(trained_pdt):
    """The port's model beside the JAX ``trained_pdt`` fixture's, trained
    on the same windows."""
    pdt_j, Xw, tr = trained_pdt
    pdt = train_partitioned_dt(Xw, tr.labels, partition_sizes=[2, 3, 2], k=4)
    for st_, st_j in zip(pdt.subtrees, pdt_j.subtrees):
        _assert_tree(st_.tree, st_j.tree, f"subtree {st_.sid}")
    return pdt, pdt_j, Xw, tr


def test_partition_queries_equal_jax(models):
    pdt, pdt_j, _, _ = models
    _assert_same(pdt.unique_features(), pdt_j.unique_features())
    assert pdt.dep_depth() == pdt_j.dep_depth()


def test_estimate_oneshot_equals_jax():
    for n, entries, key_bits, depth, flows in ((4, 5000, 40, 13, None),
                                               (6, 5000, 56, 13, 80_000),
                                               (2, 10**6, 24, 5, 10**6)):
        for target in ("TOFINO1", "PENSANDO"):
            _assert_same(
                res.estimate_oneshot(n, entries, key_bits, depth=depth,
                                     flows=flows,
                                     target=getattr(res, target)),
                j_res.estimate_oneshot(n, entries, key_bits, depth=depth,
                                       flows=flows,
                                       target=getattr(j_res, target)))


def test_estimate_equals_jax(models):
    pdt, pdt_j, _, _ = models
    _assert_same(res.model_rules(pdt), j_res.model_rules(pdt_j), "rules")
    for kw in ({}, {"bits": 16}, {"bits": 8}, {"flows": 1_000},
               {"flows": 100_000}, {"flows": 10_000_000},
               {"recirc_mbps": 2e5}, {"feature_ranges": {0: (0.0, 9.0)}}):
        for target in ("TOFINO1", "PENSANDO"):
            _assert_same(
                res.estimate(pdt, target=getattr(res, target), **kw),
                j_res.estimate(pdt_j, target=getattr(j_res, target), **kw),
                f"{target} {kw}")


# ---------------------------------------------------------------------------
# baselines (tests/test_system.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def d1_full():
    """Each package's own d1 split and full-flow features, ``(port,
    jax)``; the two are first held equal (floats to the bit)."""
    ds, ds_j = make_dataset("d1", n_flows=1200), j_make_dataset(
        "d1", n_flows=1200)
    (tr, te), (tr_j, te_j) = ds.split(), ds_j.split()
    port = (full_flow_features(tr, device="cpu"), tr.labels,
            full_flow_features(te, device="cpu"), te.labels, ds.n_classes)
    jax = (j_full_flow_features(tr_j), tr_j.labels,
           j_full_flow_features(te_j), te_j.labels, ds_j.n_classes)
    for a, b in zip(port, jax):
        _assert_same(a, b, "full-flow inputs")
    return port, jax


@pytest.mark.parametrize("style", ["nb", "leo"])
def test_oneshot_topk_equals_jax(d1_full, style):
    (X_tr, y_tr, X_te, y_te, C), (Xj_tr, yj_tr, Xj_te, yj_te, Cj) = d1_full
    for k, depth in ((2, 5), (6, 13)):
        m = baselines.train_oneshot_topk(X_tr, y_tr, k=k, depth=depth,
                                         style=style, n_classes=C)
        m_j = j_baselines.train_oneshot_topk(Xj_tr, yj_tr, k=k, depth=depth,
                                             style=style, n_classes=Cj)
        _assert_tree(m.tree, m_j.tree)
        for name in ("feature_ids", "k", "depth", "style", "tcam_entries",
                     "key_bits"):
            _assert_same(getattr(m, name), getattr(m_j, name), name)
        assert m.f1(X_te, y_te, C) == m_j.f1(Xj_te, yj_te, Cj)
        for flows in (None, 100_000):
            _assert_same(m.resources(flows=flows),
                         m_j.resources(flows=flows), "resources")


def test_best_oneshot_for_flows_equals_jax(d1_full):
    (X_tr, y_tr, X_te, y_te, C), (Xj_tr, yj_tr, Xj_te, yj_te, _) = d1_full
    kw = dict(flows=100_000, style="nb", n_classes=C, k_grid=(2, 6),
              depth_grid=(5, 13))
    m, f1 = baselines.best_oneshot_for_flows(X_tr, y_tr, X_te, y_te, **kw)
    m_j, f1_j = j_baselines.best_oneshot_for_flows(Xj_tr, yj_tr, Xj_te,
                                                   yj_te, **kw)
    assert f1 == f1_j and f1 > 0
    _assert_tree(m.tree, m_j.tree)
    assert (m.k, m.depth, m.tcam_entries) == (m_j.k, m_j.depth,
                                              m_j.tcam_entries)


# ---------------------------------------------------------------------------
# dse (tests/test_resources_dse.py)
# ---------------------------------------------------------------------------
def test_gp_and_ei_equal_jax():
    rng = np.random.default_rng(0)
    X = rng.random((20, 3))
    y = np.sin(X.sum(1) * 3)
    Xq = rng.random((7, 3))
    for ls in (0.35, 0.5):
        _assert_same(dse.GP(length_scale=ls).fit(X, y).predict(Xq),
                     j_dse.GP(length_scale=ls).fit(X, y).predict(Xq))
    mu, sd = rng.normal(size=9), rng.random(9) + 0.05
    _assert_same(dse.expected_improvement(mu, sd, 0.3),
                 j_dse.expected_improvement(mu, sd, 0.3))


def test_search_space_equals_jax():
    space, space_j = dse.SearchSpace(), j_dse.SearchSpace()
    rng, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        c, c_j = space.sample(rng), space_j.sample(rng_j)
        assert (c.k, c.partition_sizes) == (c_j.k, c_j.partition_sizes)
        assert (c.n_partitions, c.depth) == (c_j.n_partitions, c_j.depth)
        _assert_same(space.encode(c), space_j.encode(c_j))


def test_bayes_search_history_equals_jax(small_flow_ds):
    """A seeded search on the numpy trainer: the same history, every
    ``Evaluation`` field, the same best and Pareto set, and the same
    counts in the process registry."""
    tr, te = small_flow_ds.split()
    P = 4
    Xw_tr = window_features(tr, P, device="cpu")
    Xw_te = window_features(te, P, device="cpu")
    kw = dict(n_classes=small_flow_ds.n_classes, flows=100_000)
    search = dict(n_iterations=3, batch=2, n_init=4, seed=1)
    space = dict(max_partitions=4, k_max=5, depth_max=6)
    prev = obs.set_registry(obs.MetricRegistry())
    try:
        got = dse.bayes_search(
            dse.make_splidt_evaluator(Xw_tr, tr.labels, Xw_te, te.labels,
                                      **kw),
            dse.SearchSpace(**space), **search)
        evals = obs.get_registry().counter("dse_evals_total").value
        feasible = obs.get_registry().counter("dse_feasible_total").value
    finally:
        obs.set_registry(prev)
    want = j_dse.bayes_search(
        j_dse.make_splidt_evaluator(Xw_tr, tr.labels, Xw_te, te.labels,
                                    **kw),
        j_dse.SearchSpace(**space), **search)
    assert len(got.history) == len(want.history) == 4 + 3 * 2
    for i, (e, e_j) in enumerate(zip(got.history, want.history)):
        assert e.config == dse.Config(e_j.config.k,
                                      e_j.config.partition_sizes), i
        for f in dataclasses.fields(e):
            if f.name != "config":
                _assert_same(getattr(e, f.name), getattr(e_j, f.name),
                             f"history[{i}].{f.name}")
    assert got.iterations_to_best == want.iterations_to_best
    assert got.history.index(got.best) == want.history.index(want.best)
    assert [got.history.index(e) for e in got.pareto()] == \
        [want.history.index(e) for e in want.pareto()]
    assert evals == 10 and feasible == sum(e.feasible for e in got.history)


def test_evaluator_refuses_what_needs_fit():
    """The JAX package's trainer name is not the port's (``"torch"``);
    ``win_pkts_te=`` gives the batched evaluator (``repro_torch.fit``)."""
    X = np.zeros((4, 2, F.N_FEATURES), np.float32)
    y = np.zeros(4, np.int64)
    with pytest.raises(ValueError, match="unknown trainer"):
        dse.make_splidt_evaluator(X, y, X, y, n_classes=2, flows=10,
                                  trainer="jax")
    ev = dse.make_splidt_evaluator(X, y, X, y, n_classes=2, flows=10,
                                   win_pkts_te=np.zeros((4, 2, 3, 6)))
    assert callable(ev.evaluate_batch) and ev.evaluate_batch([]) == []
    with pytest.raises(ValueError, match="unknown trainer"):
        dse.make_splidt_evaluator(X, y, X, y, n_classes=2, flows=10,
                                  trainer="sklearn")
