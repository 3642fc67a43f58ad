"""The benchmark's NumPy reference against the port, on the CPU.

The generator, the windows and their features, the trainer and the walk
are frozen copies: each must equal the program's own at zero tolerance,
and the reference's verdicts must equal the port's ``fused`` route on a
small pool of each cell's mix.  The bf16 control must differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import cells, harness, model as model_lib
from portbench.ref import flows, trainer, walk, windows
from repro_torch.core import features as F
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.flows import synthetic, windows as pwin

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(config: dict, n_flows: int) -> dict:
    return dict(config, dataset=dict(config["dataset"], n_flows=n_flows))


def port_dataset(spec: dict):
    if spec["kind"] == "dataset":
        return synthetic.make_dataset(spec["name"], spec["n_flows"],
                                      seed=spec["seed"])
    return synthetic.make_profile_dataset(spec["profile"], spec["n_flows"],
                                          seed=spec["seed"])


@pytest.mark.parametrize("name", ["exitmix-333-k4", "d2-101010-k6"])
def test_training_set_is_the_programs_draw_for_draw(name):
    config = small(cells.resolve(next(
        w["name"] for w in BENCH["workloads"] if w["config"] == name)).config,
        300)
    got = flows.make_training_set(config["dataset"])
    want = port_dataset(config["dataset"])
    assert np.array_equal(got.packets, want.packets)
    assert np.array_equal(got.lengths, want.lengths)
    assert np.array_equal(got.labels, want.labels)
    assert flows.length_range(config["dataset"]) == (
        config["dataset"]["min_len"], config["dataset"]["max_len"])


def test_feature_table_is_the_programs():
    assert [(n, op, fld, pr) for n, op, fld, pr in windows.FEATURES] == [
        (s.name, s.op, s.field, s.pred) for s in F.REGISTRY]


@pytest.mark.parametrize("name", ["exitmix-333-k4", "d2-101010-k6"])
def test_windows_and_features_are_the_programs(name):
    config = next(c for c in (cells.resolve(w).config for w in CELLS)
                  if c["name"] == name)
    spec = small(config, 400)["dataset"]
    ds = port_dataset(spec)
    W = model_lib.window_width(config)
    got = windows.window_packets(ds.packets, ds.lengths, 3, W)
    want = pwin.window_packets(ds, 3)
    assert np.array_equal(got[:, :, :want.shape[2]], want)
    assert not got[:, :, want.shape[2]:].any()
    feats = windows.all_features(got, block=128)
    assert np.array_equal(feats.view(np.int32),
                          pwin.window_features(ds, 3, device="cpu")
                          .view(np.int32))


def test_window_width_of_each_configuration():
    widths = {cells.resolve(w).config["name"]:
              model_lib.window_width(cells.resolve(w).config) for w in CELLS}
    assert widths == {"exitmix-333-k4": 33, "d2-101010-k6": 65}


def _port_model(config: dict):
    ds = port_dataset(config["dataset"])
    tr, _ = ds.split(config["split"]["frac"], config["split"]["seed"])
    return train_partitioned_dt(
        pwin.window_features(tr, 3, device="cpu"), tr.labels,
        partition_sizes=config["partition_sizes"], k=config["k"],
        min_samples_subtree=config["min_samples_subtree"],
        min_samples_leaf=config["min_samples_leaf"],
        max_bins=config["max_bins"], trainer="numpy")


@pytest.mark.parametrize("name,n_flows", [("exitmix-333-k4", 1500),
                                          ("d2-101010-k6", 1200)])
def test_trainer_is_the_programs_node_for_node(name, n_flows):
    config = next(c for c in (cells.resolve(w).config for w in CELLS)
                  if c["name"] == name)
    config = small(config, n_flows)
    got = model_lib.train(config)
    want = _port_model(config)
    assert len(got.subtrees) == len(want.subtrees) > 1
    for g, w in zip(got.subtrees, want.subtrees):
        assert g.partition == w.partition
        for f in ("feature", "threshold", "left", "right", "value"):
            assert np.array_equal(getattr(g.tree, f), getattr(w.tree, f)), f
        leaves = np.nonzero(g.tree.feature < 0)[0]
        assert {int(i): int(g.next_sid[i]) for i in leaves} \
            == w.leaf_next_sid
    # the walk against the program's own numpy walk of its model
    ds = flows.make_training_set(config["dataset"])
    X = windows.all_features(windows.window_packets(
        ds.packets, ds.lengths, 3, model_lib.window_width(config)))
    ref = walk.walk(got, X)
    labels, recircs, exit_p = want.predict(X, return_trace=True)
    assert np.array_equal(ref.labels, labels)
    assert np.array_equal(ref.recircs, recircs)
    assert np.array_equal(ref.exit_p, exit_p)


def test_model_save_and_load_round_trip(tmp_path):
    config = small(cells.resolve(CELLS[0]).config, 900)
    m = model_lib.train(config)
    m.save(tmp_path / "m.npz")
    back = trainer.Model.load(tmp_path / "m.npz")
    assert (back.k, back.n_classes, back.partition_sizes) == (
        m.k, m.n_classes, m.partition_sizes)
    for a, b in zip(m.subtrees, back.subtrees):
        assert a.partition == b.partition
        assert np.array_equal(a.next_sid, b.next_sid)
        for f in ("feature", "threshold", "left", "right", "value"):
            assert np.array_equal(getattr(a.tree, f), getattr(b.tree, f))


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(model_lib, "CACHE", tmp_path)
    return tmp_path


def _small_cell(name: str, n_train: int, pool: int, batch: int):
    cell = cells.resolve(name)
    traffic = dict(cell.traffic, pool_flows=pool, batch_flows=batch,
                   batches=2)
    return dataclasses.replace(cell, config=small(cell.config, n_train),
                               traffic=traffic)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_ports_fused_route(name, tmp_cache):
    cell = _small_cell(name, 1500, 256, 512)
    pool_rng, batch_rng, _ = harness.seeds(2**31 + 17)
    x = harness.inputs(cell, cell.traffic, pool_rng, batch_rng)
    ref = walk.walk(x.model, windows.all_features(x.pool_windows))
    from portbench import program
    eng = program.engine(x.model, "cpu")
    opts = program.options(cell.traffic).replace(impl="fused")
    for r in x.rows:
        res = eng.run(torch.from_numpy(x.pool_windows[r]),
                      with_trace=False, options=opts)
        assert np.array_equal(res.labels, ref.labels[r])
        assert np.array_equal(res.recircs, ref.recircs[r])
        assert np.array_equal(res.exit_partition, ref.exit_p[r])
    assert (ref.exit_p >= 0).all()


def test_pool_is_seeded_and_keeps_its_sizes_across_seeds():
    spec = cells.resolve("exitmix-333-k4.early").config["dataset"]
    w = [0.8, 0.1, 0.05, 0.05]
    a = flows.make_pool(spec, w, 1000, np.random.default_rng(1))
    b = flows.make_pool(spec, w, 1000, np.random.default_rng(1))
    c = flows.make_pool(spec, w, 1000, np.random.default_rng(2))
    assert np.array_equal(a.packets, b.packets)
    assert not np.array_equal(a.packets, c.packets)
    assert np.array_equal(np.sort(a.lengths), np.sort(c.lengths))
    assert np.bincount(a.labels).tolist() == [800, 100, 50, 50]
    assert np.array_equal(np.bincount(a.labels), np.bincount(c.labels))
    valid = a.packets[..., flows.VALID] > 0
    assert np.array_equal(valid.sum(axis=1), a.lengths)
    assert (a.packets[~valid] == 0).all()
    assert (a.packets[:, 0, flows.IAT] == 0).all()
    assert (a.packets[:, 0, flows.FLAGS].astype(int) & flows.SYN).all()


def test_bf16_rounds_to_nearest_even():
    x = np.asarray([1.0, 1.00390625, 1.005859375, 1.0078125, 3e38,
                    np.float32(np.finfo(np.float32).max), -2.5, 1e-30],
                   np.float32)
    x = np.concatenate([x, np.random.default_rng(0).standard_normal(
        10000).astype(np.float32) * 1e3])
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(windows.bf16(x), want)
    assert windows.bf16(x)[:3].tolist() == [1.0, 1.0, 1.0078125]
