"""The port's trainer (``repro_torch.fit``) vs the JAX package's
``repro.fit`` and the numpy oracle, at zero tolerance, on the CPU.

* ``class_sq_chain``, ``_level_hist``, ``_level_scores`` and
  ``budget_level`` equal their JAX twins bit for bit on random fleets
  with ties, empty nodes and all-``inf`` / all-``-inf`` rows (the first
  extremum wins in both);
* ``train_tree_torch`` equals ``train_tree`` and ``train_tree_jax`` node
  for node (feature, threshold, left, right, value) and keeps the k
  budget; ``train_forest`` equals per-tree training, in one fleet and in
  chunks;
* ``train_partitioned_dt(trainer="torch", device="cpu")`` equals the
  numpy trainer and the JAX ``trainer="jax"`` subtree for subtree;
* ``pack_model_fleet`` equals JAX's arrays; ``fleet_predict`` equals
  JAX's and each ``pdt.predict``; ``evaluate_batch`` equals the serial
  evaluator; a seeded ``bayes_search`` on the torch trainer and the
  batched evaluator gives JAX's ``trainer="jax"`` history;
* on the card (marker ``gpu``): the card trainer equals the CPU trainer,
  and ``fleet_predict`` equals the CPU walk with one hop-kernel launch
  a model's partition and none of kernels A and B.

Inputs are made with numpy from a seed and handed to both packages.
JAX is imported in a fixture, so on the card's machine (no JAX) the
``gpu`` tests still run.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import dse
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.core.tree import train_tree
from repro_torch.fit import (
    batched, distinct_feature_count, fleet_predict, pack_model_fleet,
    train_forest, train_tree_torch,
)
from repro_torch.fit import hist, kbudget
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.kernels import dt_traverse
from repro_torch.kernels import engine_hop as eh
from repro_torch.kernels import feature_window as fw

_TREE = ("feature", "threshold", "left", "right", "value")
CPU = "cpu"


@pytest.fixture(scope="module")
def jx():
    """The JAX package, the reference.  The card's machine has no JAX, so
    there only the card tests of this file run."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import dse as j_dse
    from repro.core.partition import train_partitioned_dt as j_train
    from repro.fit import batched as j_batched
    from repro.fit import hist as j_hist
    from repro.fit import kbudget as j_kbudget
    return types.SimpleNamespace(jnp=jnp, dse=j_dse, train=j_train,
                                 batched=j_batched, hist=j_hist,
                                 kbudget=j_kbudget)


@pytest.fixture(scope="module")
def flows():
    """``make_dataset("d2", 1200)`` (``tests/test_fit.py``'s
    ``small_flow_ds``) split 70/30, with three windows."""
    ds = make_dataset("d2", n_flows=1200)
    tr, te = ds.split()
    P = 3
    return types.SimpleNamespace(
        n_classes=ds.n_classes, y_tr=tr.labels, y_te=te.labels,
        Xw_tr=window_features(tr, P, device=CPU),
        Xw_te=window_features(te, P, device=CPU),
        wp_te=window_packets(te, P))


@pytest.fixture(scope="module")
def fleet_models(flows):
    """Three models of 3, 2 and 1 partitions (k = 3, 4, 2)."""
    return [train_partitioned_dt(flows.Xw_tr[:, :p], flows.y_tr,
                                 partition_sizes=sizes, k=k,
                                 n_classes=flows.n_classes)
            for p, sizes, k in [(3, [2, 2, 2], 3), (2, [3, 2], 4),
                                (1, [4], 2)]]


def _assert_trees_equal(a, b, ctx=""):
    for name in _TREE:
        np.testing.assert_array_equal(
            getattr(a, name), getattr(b, name),
            err_msg=f"{ctx}: Tree.{name} diverged")


def _assert_pdts_equal(a, b):
    assert len(a.subtrees) == len(b.subtrees)
    for x, y in zip(a.subtrees, b.subtrees):
        assert (x.sid, x.partition) == (y.sid, y.partition)
        assert x.leaf_next_sid == y.leaf_next_sid
        assert x.leaf_label == y.leaf_label
        _assert_trees_equal(x.tree, y.tree, ctx=f"sid={x.sid}")


def _bits(a):
    """Arrays compared to the bit (f32 through its int32 view)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _random_fleet_hist(seed: int, N: int, m: int, nbins: int,
                       C: int) -> np.ndarray:
    """A level histogram (N, m, nbins, C) int32 made from samples, with
    the cases that decide ties: empty nodes (all ``inf``: no split),
    single-sample and pure nodes, a feature whose samples share one bin
    (all ``inf``), a feature on few bins (empty bins: tied child
    scores) and a duplicated feature (tied gains)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((N, m, nbins, C), np.int32)
    for i in range(N):
        n = int(rng.choice([0, 1, 5, 40, 200]))
        y = rng.integers(0, C if rng.random() < 0.8 else 1, n)
        for j in range(m):
            b = (np.full(n, 3) if j == m - 1 else
                 rng.integers(0, nbins // 4 if j == 0 else nbins, n))
            np.add.at(h[i, j], (b, y), 1)
    h[:, m // 2] = h[:, 1]
    return h


# ---------------------------------------------------------------------------
# the grower's pieces, bit for bit against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5,), (3, 4, 2), (2, 3, 5, 7)])
def test_class_sq_chain_equals_jax(jx, shape):
    rng = np.random.default_rng(len(shape))
    c = rng.integers(0, 1 << 17, size=shape).astype(np.int32)
    got = hist.class_sq_chain(torch.from_numpy(c)).numpy()
    want = np.asarray(jx.hist.class_sq_chain(jx.jnp.asarray(c)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,S,F,n,m,nbins,C", [
    (0, 1, 1, 50, 3, 8, 2), (1, 3, 4, 200, 5, 16, 3),
    (2, 4, 8, 300, 7, 8, 4)])
def test_level_hist_equals_jax(jx, seed, S, F, n, m, nbins, C):
    """One scatter over the fleet == JAX's per-tree scatter; inactive
    samples (``seg == F``) are dropped, none counted."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, nbins, size=(S, n, m)).astype(np.int32)
    y = rng.integers(0, C, size=(S, n)).astype(np.int32)
    seg = rng.integers(0, F + 1, size=(S, n)).astype(np.int32)
    got = hist._level_hist(torch.from_numpy(binned), torch.from_numpy(y),
                           torch.from_numpy(seg), frontier=F, nbins=nbins,
                           n_classes=C).numpy()
    assert got.dtype == np.int32
    for s in range(S):
        want = np.asarray(jx.hist._level_hist(
            jx.jnp.asarray(binned[s]), jx.jnp.asarray(y[s]),
            jx.jnp.asarray(seg[s]), frontier=F, nbins=nbins, n_classes=C))
        np.testing.assert_array_equal(got[s], want)
    assert got.sum() == (seg < F).sum() * m


@pytest.mark.parametrize("seed,S,F,m,nbins,C", [
    (0, 2, 4, 3, 8, 2), (1, 2, 4, 5, 8, 3), (2, 3, 8, 6, 16, 4),
    (3, 2, 16, 9, 24, 5)])
def test_level_scores_equal_jax(jx, seed, S, F, m, nbins, C):
    h = _random_fleet_hist(seed, S * F, m, nbins, C)
    got = hist._level_scores(torch.from_numpy(h))
    want = jx.hist._level_scores(jx.jnp.asarray(h))
    for name, g, w in zip(("gain", "bin", "nl", "total"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    left = np.cumsum(h, axis=2)[np.arange(S * F)[:, None], np.arange(m),
                                got[1].numpy()]
    np.testing.assert_array_equal(got[4].numpy(), left, err_msg="left")
    gain = got[0].numpy()
    # the cases that decide ties are present: no split anywhere in a node
    # (all -inf, bin 0) and gains tied across features
    assert (np.isneginf(gain).all(axis=1)).any()
    assert (got[1].numpy()[np.isneginf(gain)] == 0).all()
    assert (gain[:, 1] == gain[:, m // 2]).all()
    assert np.isneginf(gain[:, m - 1]).all()


@pytest.mark.parametrize("seed,depth,k", [(0, 3, 2), (1, 5, 4)])
def test_grow_arena_equals_jax(jx, seed, depth, k):
    """One tree's arena (the fleet of one) == JAX ``grow_arena``, padding
    rows and a masked feature included."""
    rng = np.random.default_rng(seed)
    n, m, nbins, C = 120, 6, 16, 3
    binned = rng.integers(0, nbins, size=(n, m)).astype(np.int32)
    y = rng.integers(0, C, size=n).astype(np.int32)
    y[binned[:, 1] < 4] = 0
    valid = rng.random(n) < 0.9
    allowed = np.ones(m, bool)
    allowed[2] = False
    kw = dict(depth=depth, n_classes=C, nbins=nbins, k_features=k,
              min_samples_leaf=2, min_gain=1e-7)
    got = hist.grow_arena(torch.from_numpy(binned), torch.from_numpy(y),
                          torch.from_numpy(valid), allowed, **kw)
    want = jx.hist.grow_arena(jx.jnp.asarray(binned), jx.jnp.asarray(y),
                              jx.jnp.asarray(valid), jx.jnp.asarray(allowed),
                              **kw)
    for name, g, w in zip(("feat", "bin", "counts", "last_counts", "used"),
                          got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert (got[0] >= 0).any() and got[4].sum() <= k


def test_first_extremum_on_ties():
    """``argmin`` / ``argmax`` give the first extremum, all-``inf`` and
    all-``-inf`` rows included, as ``jnp`` and numpy do."""
    inf = float("inf")
    x = torch.tensor([[3.0, 1.0, 1.0], [inf, inf, inf], [2.0, 2.0, 5.0],
                      [-inf, -inf, -inf]])
    assert torch.argmin(x, dim=1).tolist() == [1, 0, 0, 0]
    assert torch.argmax(x, dim=1).tolist() == [0, 0, 2, 0]


@pytest.mark.parametrize("seed,k,msl,min_gain", [
    (0, 1, 1, 1e-7), (1, 2, 2, 1e-7), (2, 3, 1, 0.0), (3, 9, 3, 1e-7),
    (4, 2, 0, 0.5)])
def test_budget_level_equals_jax(jx, seed, k, msl, min_gain):
    """The fleet pass == JAX's scan tree by tree, with tied gains, rows of
    -inf, empty and pure slots and used masks carried in."""
    S, F, m, C = 4, 8, 9, 3
    rng = np.random.default_rng(seed)
    gain = rng.choice(np.float32([0.25, 0.5, 2.0, 3.0, -np.inf]),
                      size=(S, F, m)).astype(np.float32)
    gain[:, 2] = -np.inf
    bins = rng.integers(0, 12, size=(S, F, m)).astype(np.int32)
    total = rng.integers(0, 5, size=(S, F, C)).astype(np.int32)
    total[:, 3] = 0                                   # an empty slot
    total[:, 4, 1:] = 0                               # a pure slot
    n_node = total.sum(axis=2)
    nl = (rng.random((S, F, m)) * (n_node[..., None] + 1)).astype(np.int32)
    used = rng.random((S, m)) < 0.2
    allowed = rng.random(m) < 0.8
    got = kbudget.budget_level(
        used, gain, bins, nl, total, allowed_mask=allowed, k_features=k,
        min_samples_leaf=msl, min_gain32=np.float32(min_gain))
    for s in range(S):
        want = jx.kbudget.budget_level(
            jx.jnp.asarray(used[s]), jx.jnp.asarray(gain[s]),
            jx.jnp.asarray(bins[s]), jx.jnp.asarray(nl[s]),
            jx.jnp.asarray(total[s]), allowed_mask=jx.jnp.asarray(allowed),
            k_features=k, min_samples_leaf=msl,
            min_gain32=jx.jnp.float32(min_gain))
        for name, g, w in zip(("used", "feat", "bin"), got, want):
            np.testing.assert_array_equal(g[s], np.asarray(w),
                                          err_msg=f"tree {s}: {name}")
    assert (got[1] >= 0).any() and (got[1] < 0).any()


def test_distinct_feature_count():
    f = np.array([3, -1, 3, 0, 7, -1, 0], np.int32)
    assert int(distinct_feature_count(f, 8)) == 3
    assert int(distinct_feature_count(np.full(4, -1, np.int32), 8)) == 0


# ---------------------------------------------------------------------------
# trees, node for node
# ---------------------------------------------------------------------------
def _random_problem(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 400))
    m = int(rng.integers(2, 14))
    C = int(rng.integers(2, 6))
    depth = int(rng.integers(1, 7))
    k = int(rng.integers(1, m + 1)) if rng.random() < 0.7 else None
    msl = int(rng.integers(1, 6))
    X = rng.normal(size=(n, m)).astype(np.float32)
    if rng.random() < 0.3:      # duplicate-heavy columns stress tie-breaks
        X = np.round(X * 2) / 2
    y = rng.integers(0, C, n)
    allowed = (np.sort(rng.choice(m, size=int(rng.integers(1, m + 1)),
                                  replace=False))
               if rng.random() < 0.3 else None)
    return X, y, dict(max_depth=depth, k_features=k, n_classes=C,
                      min_samples_leaf=msl, allowed_features=allowed)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_torch_trees_equal_numpy_oracle(seed):
    """Random n/m/C/depth/k/min_samples_leaf, some with allowed features:
    the torch grower's tree == ``train_tree``'s, and the budget holds."""
    X, y, kw = _random_problem(seed)
    t = train_tree_torch(X, y, device=CPU, **kw)
    _assert_trees_equal(train_tree(X, y, **kw), t, ctx=f"seed={seed}")
    if kw["k_features"] is not None:
        assert int(distinct_feature_count(t.feature, X.shape[1])) \
            <= kw["k_features"]
    if kw["allowed_features"] is not None:
        assert set(t.used_features()) <= set(kw["allowed_features"])
    assert t.max_depth <= kw["max_depth"]


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_torch_trees_equal_jax_trees(jx, seed):
    X, y, kw = _random_problem(seed)
    _assert_trees_equal(train_tree_torch(X, y, device=CPU, **kw),
                        jx.batched.train_tree_jax(X, y, **kw),
                        ctx=f"seed={seed}")


def test_depth_zero_is_one_leaf():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    y = rng.integers(0, 3, 40)
    _assert_trees_equal(train_tree(X, y, max_depth=0, n_classes=3),
                        train_tree_torch(X, y, max_depth=0, n_classes=3,
                                         device=CPU))


@pytest.mark.parametrize("budget", [None, 30_000])
def test_forest_matches_per_tree_training(monkeypatch, budget):
    """One fleet == each subset trained alone.  The fleet of 7 runs in
    chunks of a power of two, the last one padded with empty trees: 4
    under the default budget, 2 under a budget of 30,000 histogram
    elements (a tree takes 2^3 x 8 x 64 x 3)."""
    if budget is not None:
        monkeypatch.setattr(batched, "_HIST_BUDGET", budget)
    rng = np.random.default_rng(3)
    Xs, ys = [], []
    for _ in range(7):
        n = int(rng.integers(40, 200))
        Xs.append(rng.normal(size=(n, 8)).astype(np.float32))
        ys.append(rng.integers(0, 3, n))
    runs = []
    real = hist.grow_forest_arenas
    monkeypatch.setattr(hist, "grow_forest_arenas",
                        lambda b, *a, **kw: runs.append(b.shape[0])
                        or real(b, *a, **kw))
    fleet = train_forest(Xs, ys, max_depth=4, k_features=3, n_classes=3,
                         device=CPU)
    assert runs == ([4, 4] if budget is None else [2, 2, 2, 2])
    for i, (X, y) in enumerate(zip(Xs, ys)):
        solo = train_tree(X, y, max_depth=4, k_features=3, n_classes=3)
        _assert_trees_equal(solo, fleet[i], ctx=f"fleet[{i}]")


def test_grower_fetches_once_a_level():
    """One host fetch a level run, the bottom level's counts with the
    last; a fleet whose trees stop early runs no level below them."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)             # one split separates
    hist.host_syncs = 0
    t = train_tree_torch(X, y, max_depth=6, n_classes=2, device=CPU)
    assert t.max_depth == 1 and hist.host_syncs == 2
    hist.host_syncs = 0
    y3 = rng.integers(0, 3, 300)
    t3 = train_tree_torch(X, y3, max_depth=3, n_classes=3, device=CPU,
                          min_samples_leaf=1)
    assert t3.max_depth == 3 and hist.host_syncs == 3


def test_partitioned_trainer_parity(jx, flows):
    """``trainer="torch"`` on the CPU == the numpy trainer == the JAX
    ``trainer="jax"``, subtree for subtree."""
    kw = dict(partition_sizes=[2, 3, 2], k=4, n_classes=flows.n_classes)
    p_np = train_partitioned_dt(flows.Xw_tr, flows.y_tr, **kw)
    p_t = train_partitioned_dt(flows.Xw_tr, flows.y_tr, trainer="torch",
                               device=CPU, **kw)
    p_j = jx.train(flows.Xw_tr, flows.y_tr, trainer="jax", **kw)
    _assert_pdts_equal(p_np, p_t)
    _assert_pdts_equal(p_j, p_t)
    p_dep = train_partitioned_dt(flows.Xw_tr, flows.y_tr, trainer="torch",
                                 device=CPU, max_dep_depth=0, **kw)
    _assert_pdts_equal(train_partitioned_dt(flows.Xw_tr, flows.y_tr,
                                            max_dep_depth=0, **kw), p_dep)


def test_entry_points_default_to_the_card(flows):
    """``device=None`` is the card: without one the trainer and the
    fleet raise, never falling back to the CPU; with one they run
    there."""
    X, y = flows.Xw_tr[:200], flows.y_tr[:200]
    kw = dict(partition_sizes=[2], k=2, n_classes=flows.n_classes)
    if torch.cuda.is_available():
        _assert_pdts_equal(train_partitioned_dt(X, y, **kw),
                           train_partitioned_dt(X, y, trainer="torch", **kw))
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_partitioned_dt(X, y, trainer="torch", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_forest([X[:, 0]], [y], max_depth=2, n_classes=4)
    pdt = train_partitioned_dt(X, y, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_predict([pdt], flows.wp_te[:10, :1])
    with pytest.raises(ValueError, match="unknown trainer"):
        train_partitioned_dt(X, y, trainer="jax", **kw)


# ---------------------------------------------------------------------------
# DSE candidate fleets
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet_models_jax(jx, flows):
    """The same three models, trained by the JAX package."""
    return [jx.train(flows.Xw_tr[:, :p], flows.y_tr, partition_sizes=sizes,
                     k=k, n_classes=flows.n_classes)
            for p, sizes, k in [(3, [2, 2, 2], 3), (2, [3, 2], 4),
                                (1, [4], 2)]]


def test_pack_model_fleet_equals_jax(jx, fleet_models, fleet_models_jax):
    got, S = pack_model_fleet(fleet_models, device=CPU)
    want, S_j = jx.batched.pack_model_fleet(fleet_models_jax)
    assert S == S_j
    for name, g, w in zip(type(got)._fields, got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)),
                                      err_msg=name)


def test_fleet_predict_equals_jax_and_oracle(jx, flows, fleet_models,
                                             fleet_models_jax):
    got = fleet_predict(fleet_models, flows.wp_te, device=CPU)
    want = jx.batched.fleet_predict(fleet_models_jax, flows.wp_te)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (3, flows.wp_te.shape[0])
        np.testing.assert_array_equal(g, np.asarray(w))
    for i, pdt in enumerate(fleet_models):
        ref = pdt.predict(flows.Xw_te[:, :pdt.n_partitions],
                          return_trace=True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i], r)
    with pytest.raises(ValueError, match="fewer windows"):
        fleet_predict(fleet_models, flows.wp_te[:, :2], device=CPU)


def test_evaluate_batch_matches_serial(flows):
    ev = dse.make_splidt_evaluator(
        flows.Xw_tr, flows.y_tr, flows.Xw_te, flows.y_te,
        n_classes=flows.n_classes, flows=100_000, trainer="torch",
        win_pkts_te=flows.wp_te, device=CPU)
    cfgs = [dse.Config(3, (2, 2)), dse.Config(2, (3,)),
            dse.Config(4, (2, 2, 2))]
    for cfg, b in zip(cfgs, ev.evaluate_batch(cfgs)):
        assert ev(cfg) == b, cfg


def test_evaluate_batch_retries_on_dependency_free_features(flows,
                                                            monkeypatch):
    """At a flow target where dependency registers bind, the batch retries
    the failures on ``max_dep_depth=0`` as the serial evaluator does: at
    700,000 flows (3, (3, 3)) becomes feasible on the retry and
    (4, (3, 3)) does not."""
    ev = dse.make_splidt_evaluator(
        flows.Xw_tr, flows.y_tr, flows.Xw_te, flows.y_te,
        n_classes=flows.n_classes, flows=700_000, trainer="torch",
        win_pkts_te=flows.wp_te, device=CPU)
    cfgs = [dse.Config(3, (3, 3)), dse.Config(4, (3, 3)),
            dse.Config(1, (2,))]
    retried = []
    train = dse.train_partitioned_dt
    monkeypatch.setattr(dse, "train_partitioned_dt", lambda *a, **kw: (
        retried.append((kw["k"], kw["max_dep_depth"])) or train(*a, **kw)))
    batch = ev.evaluate_batch(cfgs)
    assert [k for k, dep in retried if dep == 0] == [3, 4]
    assert [e.feasible for e in batch] == [True, False, True]
    for cfg, b in zip(cfgs, batch):
        assert ev(cfg) == b, cfg


def test_bayes_search_history_equals_jax(jx, flows):
    """A seeded search, ``trainer="torch"`` with the batched evaluator,
    gives JAX's ``trainer="jax"`` batched history field for field."""
    space = dict(max_partitions=3, k_max=4, depth_max=4)
    search = dict(n_iterations=2, batch=3, n_init=4, seed=0)
    common = (flows.Xw_tr, flows.y_tr, flows.Xw_te, flows.y_te)
    kw = dict(n_classes=flows.n_classes, flows=100_000,
              win_pkts_te=flows.wp_te)
    got = dse.bayes_search(
        dse.make_splidt_evaluator(*common, trainer="torch", device=CPU,
                                  **kw),
        dse.SearchSpace(**space), **search)
    want = jx.dse.bayes_search(
        jx.dse.make_splidt_evaluator(*common, trainer="jax", **kw),
        jx.dse.SearchSpace(**space), **search)
    assert len(got.history) == len(want.history) == 4 + 2 * 3
    for i, (e, e_j) in enumerate(zip(got.history, want.history)):
        assert e.config == dse.Config(e_j.config.k,
                                      e_j.config.partition_sizes), i
        for f in dataclasses.fields(e):
            if f.name != "config":
                assert getattr(e, f.name) == getattr(e_j, f.name), \
                    f"history[{i}].{f.name}"
    assert got.best.config == dse.Config(want.best.config.k,
                                         want.best.config.partition_sizes)
    assert got.iterations_to_best == want.iterations_to_best


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hop kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_trainer_equals_cpu_trainer(card, flows):
    for sizes, k in (([2, 3, 2], 4), ([6, 5], 6)):
        kw = dict(partition_sizes=sizes, k=k, n_classes=flows.n_classes,
                  trainer="torch")
        _assert_pdts_equal(
            train_partitioned_dt(flows.Xw_tr, flows.y_tr, device=CPU, **kw),
            train_partitioned_dt(flows.Xw_tr, flows.y_tr, device=card, **kw))


@pytest.mark.gpu
def test_card_fleet_predict_equals_cpu(card, flows, fleet_models):
    fw.launches = dt_traverse.launches = eh.launches = 0
    got = fleet_predict(fleet_models, flows.wp_te, device=card)
    launches = (eh.launches, fw.launches, dt_traverse.launches)
    want = fleet_predict(fleet_models, flows.wp_te, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert launches == (sum(p.n_partitions for p in fleet_models), 0, 0)
