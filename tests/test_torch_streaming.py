"""The port's streaming scheduler (``serve/streaming.py``) against the JAX
package's, at zero tolerance, on the CPU; and on the card.

Every chunking -- single-flow chunks, ragged tails, chunks larger than the
batch, any ``inflight`` depth, compaction, ``stream_batches``, an 8-entry
CPU mesh with micro-batches that do not divide it, donation on and off --
gives the port's ``Engine.run`` verdicts and the JAX ``run_streaming``
verdicts on the same windows (``np.testing.assert_array_equal``), int32
with ``-1`` sentinels.  The JAX package shards over 8 fake devices in a
subprocess (``tests/test_sharded_streaming.py``) and holds its sharded
run to its unsharded one; here the port's 8-entry mesh is held to the
JAX unsharded run on the same micro-batch, which that file shows equal.

On the card (marker ``gpu``): streamed verdicts equal the CPU route for
``inflight`` 1-3 and a ragged tail, one hop-kernel launch a hop and chunk,
and the call's device memory is that of ``inflight`` chunks, not of B.

Inputs: the shared ``trained_pdt`` fixture (d2, 840 training flows,
(2, 3, 2), k = 4) on the port's engine over the JAX engine's tables
(``convert``); the property test trains fresh models from a seed.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.convert import engine_tables_from_arrays
from repro_torch.core.inference import Engine, EngineOptions
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.distributed.sharding import flow_batch_devices, flow_shards
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.launch.mesh import (
    FlowMesh, make_flow_mesh, mesh_shape_dict,
)
from repro_torch.obs import MetricRegistry
from repro_torch.serve import microbatches, run_streaming, stream_batches
from repro_torch.tuning import Plan

try:
    from repro.testing.hypothesis_compat import given, settings
    from repro.testing.hypothesis_compat import strategies as st
except ImportError:                      # the card's machine has no JAX
    from hypothesis import given, settings
    from hypothesis import strategies as st


@pytest.fixture(scope="module")
def jx(trained_pdt):
    """The JAX engine and scheduler, the port's engine over the same
    tables, the training split's windows and both full-batch runs."""
    pytest.importorskip("jax.numpy")
    from repro.core.inference import Engine as JEngine
    from repro.core.inference import EngineOptions as JOptions
    from repro.serve.streaming import microbatches as j_microbatches
    from repro.serve.streaming import run_streaming as j_run_streaming
    pdt, Xw, tr = trained_pdt
    jeng = JEngine.from_model(pdt)
    arrays = {n: np.asarray(getattr(jeng.dev, n)) for n in jeng.dev._fields}
    eng = Engine.from_tables(engine_tables_from_arrays(
        arrays, n_subtrees=jeng.ret.n_subtrees,
        n_partitions=pdt.n_partitions, n_classes=jeng.ret.n_classes,
        device="cpu"))
    wp = window_packets(tr, 3)
    full = eng.run(wp, with_trace=False)
    _assert_same(full, jeng.run(wp, with_trace=False,
                                options=JOptions(impl="fused")))
    return types.SimpleNamespace(
        eng=eng, jeng=jeng, Options=JOptions, stream=j_run_streaming,
        microbatches=j_microbatches, wp=wp, full=full,
        oracle=pdt.predict(Xw, return_trace=True))


def _assert_same(res, want, what: str = ""):
    for name in ("labels", "recircs", "exit_partition"):
        got = getattr(res, name)
        assert got.dtype == np.int32, (what, name)
        np.testing.assert_array_equal(got, getattr(want, name),
                                      err_msg=f"{what}: {name}")


def _both(jx, **knobs):
    """The port's ``run_streaming`` and the JAX one with the same knobs;
    the port's is returned after both are held to the full runs."""
    res = run_streaming(jx.eng, jx.wp, options=EngineOptions(**knobs))
    jknobs = {k: v for k, v in knobs.items() if k != "mesh"}
    jres = jx.stream(jx.jeng, jx.wp, options=jx.Options(
        impl="fused", **jknobs))
    _assert_same(res, jres, f"vs JAX run_streaming {knobs}")
    _assert_same(res, jx.full, f"vs Engine.run {knobs}")
    return res


@pytest.mark.parametrize("n,mb", [(103, 32), (32, 32), (0, 8), (5, 100)])
def test_microbatch_bounds_equal_jax(jx, n, mb):
    assert list(microbatches(n, mb)) == list(jx.microbatches(n, mb))
    with pytest.raises(ValueError):
        list(microbatches(10, 0))


@pytest.mark.parametrize("micro_batch", [1, 7, 64, 10_000])
def test_streaming_equals_full_batch(jx, micro_batch):
    """Every chunking -- single-flow, ragged tail, one giant chunk --
    gives the full-batch run's verdicts, as in the JAX package."""
    res = _both(jx, micro_batch=micro_batch)
    assert res.plan is None and res.regs_trace == []


def test_streaming_matches_oracle(jx):
    """The method form, chunked, still equals the numpy oracle (labels
    and recirculation counts)."""
    res = jx.eng.run_streaming(jx.wp, options=EngineOptions(micro_batch=50))
    for got, want in zip((res.labels, res.recircs, res.exit_partition),
                         jx.oracle):
        np.testing.assert_array_equal(got, want)


def test_streaming_ragged_tail_of_one_flow(jx):
    _both(jx, micro_batch=jx.wp.shape[0] - 1)


def test_stream_batches_generator(jx):
    """Open-stream form: per-batch results concatenate to the full run."""
    cuts = [0, 13, 200, jx.wp.shape[0]]
    parts = [jx.wp[a:b] for a, b in zip(cuts, cuts[1:])]
    outs = list(stream_batches(jx.eng, parts,
                               options=EngineOptions(micro_batch=64)))
    assert len(outs) == len(parts)
    for name in ("labels", "recircs", "exit_partition"):
        got = np.concatenate([getattr(o, name) for o in outs])
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, getattr(jx.full, name))


@pytest.mark.parametrize("donate", [False, True])
def test_streaming_donate_flag_explicit(jx, donate):
    _both(jx, micro_batch=33, donate=donate)


def test_default_micro_batch_per_device(jx):
    """``micro_batch=None`` chunks by ``MICRO_BATCH`` for the engine's
    device: the JAX package's 4,096 on the CPU, 65,536 on a card."""
    from repro_torch.core.inference import MICRO_BATCH
    assert EngineOptions().micro_batch is None
    assert MICRO_BATCH == {"cpu": 4096, "cuda": 65536}
    assert jx.Options().micro_batch == MICRO_BATCH["cpu"]
    big = np.concatenate([jx.wp] * 5)             # 4,200 flows: 2 chunks
    reg = MetricRegistry()
    prev = obs.set_registry(reg)
    try:
        res = run_streaming(jx.eng, big, options=EngineOptions())
    finally:
        obs.set_registry(prev)
    assert reg.counter("stream_chunks_total",
                       labels={"backend": "fused"}).value == 2
    np.testing.assert_array_equal(res.labels, np.tile(jx.full.labels, 5))
    with pytest.raises(ValueError, match="micro_batch"):
        EngineOptions(micro_batch=0)


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_streaming_pipelining_depth(jx, inflight):
    """Chunks collected out of the host loop land in the right rows at any
    depth."""
    _both(jx, micro_batch=40, inflight=inflight)
    with pytest.raises(ValueError, match="inflight"):
        EngineOptions(inflight=0)


def test_streaming_rejects_looped_backend(jx):
    with pytest.raises(ValueError, match="walk backend"):
        run_streaming(jx.eng, jx.wp, options=EngineOptions(impl="looped"))
    with pytest.raises(ValueError, match="walk backend"):
        run_streaming(jx.eng, jx.wp, options=EngineOptions(
            plan=Plan(backend="looped")))
    with pytest.raises(ValueError, match="CUDA"):
        run_streaming(jx.eng, jx.wp, options=EngineOptions(impl="cuda"))


@pytest.mark.parametrize("micro_batch", [40, 10_000])
def test_streaming_compact_equals_full_batch(jx, micro_batch):
    """Early-exit compaction inside each chunk's walk, ragged tail
    included, changes no verdict."""
    _both(jx, micro_batch=micro_batch, compact=True)


def test_streaming_plan_is_used_as_given(jx):
    plan = Plan(backend="fused", compact=True, compact_floor=16,
                source="forced")
    res = run_streaming(jx.eng, jx.wp, options=EngineOptions(
        plan=plan, micro_batch=96))
    assert res.plan is plan
    _assert_same(res, jx.full)


def test_streaming_keeps_sentinels_of_flows_that_never_exit():
    """A model whose last partition routes some flows onward: those flows
    keep the ``-1`` sentinels through every chunking."""
    ds = make_dataset("d2", n_flows=300, seed=7)
    Xw = window_features(ds, 3, device="cpu")
    pdt = train_partitioned_dt(Xw, ds.labels, partition_sizes=[2, 2, 2],
                               k=3)
    for st_ in pdt.subtrees:     # the last partition routes, never exits
        if st_.partition == pdt.n_partitions - 1:
            for leaf in st_.leaf_next_sid:
                st_.leaf_next_sid[leaf] = st_.sid
    eng = Engine.from_model(pdt, device="cpu")
    wp = window_packets(ds, 3)
    full = eng.run(wp, with_trace=False)
    assert 0 < full.n_unterminated < wp.shape[0]
    for mb in (1, 17, 1000):
        res = run_streaming(eng, wp, options=EngineOptions(micro_batch=mb,
                                                           compact=True))
        _assert_same(res, full, f"mb={mb}")
        assert res.n_unterminated == full.n_unterminated


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_streaming_padding_never_leaks_property(seed):
    """All-zero windows decode to valid exit actions, so a padding row that
    reached the result would pass for a confident verdict.  The port pads
    nothing (a ragged tail runs at its own size); for random chunkings,
    depths, compaction and an 8-entry mesh, results equal the full run
    and the JAX scheduler's, which pads its tails."""
    jnp = pytest.importorskip("jax.numpy")  # noqa: F841
    from repro.core.inference import Engine as JEngine
    from repro.core.inference import EngineOptions as JOptions
    from repro.serve.streaming import run_streaming as j_run_streaming
    rng = np.random.default_rng(seed)
    ds = make_dataset("d2", n_flows=160, seed=seed)
    Xw = window_features(ds, 2, device="cpu")
    pdt = train_partitioned_dt(Xw, ds.labels, partition_sizes=[2, 2], k=3)
    wp = window_packets(ds, 2)
    eng = Engine.from_model(pdt, device="cpu")
    jeng = JEngine.from_model(pdt)
    full = eng.run(wp, with_trace=False)
    zero = eng.run(np.zeros_like(wp[:8]), with_trace=False)
    assert (zero.labels >= 0).all()
    B = wp.shape[0]
    for _ in range(3):
        knobs = dict(micro_batch=int(rng.integers(1, B + 40)),
                     inflight=int(rng.integers(1, 4)),
                     compact=bool(rng.integers(0, 2)))
        mesh = make_flow_mesh(8, device="cpu") if rng.integers(0, 2) else None
        res = run_streaming(eng, wp, options=EngineOptions(mesh=mesh,
                                                           **knobs))
        _assert_same(res, full, f"{knobs} mesh={mesh is not None}")
        if mesh is not None:
            knobs["micro_batch"] = -(-knobs["micro_batch"] // 8) * 8
        _assert_same(res, j_run_streaming(jeng, wp, options=JOptions(
            impl="fused", **knobs)), f"vs JAX {knobs}")


# ---------------------------------------------------------------------------
# the flow mesh
# ---------------------------------------------------------------------------
def test_flow_mesh_and_shards():
    mesh = make_flow_mesh(8, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh_shape_dict(mesh) == {"data": 8}
    assert flow_batch_devices(mesh) == 8
    assert make_flow_mesh(device="cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        FlowMesh(())
    with pytest.raises(ValueError):
        make_flow_mesh(device="tpu")
    assert flow_shards(56, 8) == [(7 * j, 7 * j + 7) for j in range(8)]
    assert flow_shards(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert flow_shards(3, 8) == [(0, 1), (1, 2), (2, 3)] + [(3, 3)] * 5
    assert flow_shards(0, 2) == [(0, 0), (0, 0)]
    for n, d in ((1000, 8), (997, 3), (5, 5)):
        bounds = flow_shards(n, d)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.fixture(scope="module")
def cpu_mesh():
    return make_flow_mesh(8, device="cpu")


@pytest.mark.parametrize("micro_batch", [64, "B-1", 10_000, 96, 50])
def test_sharded_parity_and_ragged_tails(jx, cpu_mesh, micro_batch):
    """An 8-entry CPU mesh: micro-batches with an uneven last chunk, that
    do not divide 8 (50 is rounded up to 56, as the JAX scheduler rounds
    it) or that exceed B; equal to Engine.run and to the JAX scheduler
    on the rounded micro-batch."""
    B = jx.wp.shape[0]
    mb = B - 1 if micro_batch == "B-1" else micro_batch
    rounded = -(-mb // 8) * 8
    reg = MetricRegistry()
    prev = obs.set_registry(reg)
    try:
        res = run_streaming(jx.eng, jx.wp, options=EngineOptions(
            micro_batch=mb, mesh=cpu_mesh))
    finally:
        obs.set_registry(prev)
    _assert_same(res, jx.full)
    _assert_same(res, jx.stream(jx.jeng, jx.wp, options=jx.Options(
        impl="fused", micro_batch=rounded)))
    assert reg.counter("stream_chunks_total",
                       labels={"backend": "fused"}).value == -(-B // rounded)


@pytest.mark.parametrize("donate,inflight", [(True, 2), (False, 2),
                                             (True, 1)])
def test_sharded_donation_on_off(jx, cpu_mesh, donate, inflight):
    _both(jx, micro_batch=128, mesh=cpu_mesh, donate=donate,
          inflight=inflight)


@pytest.mark.parametrize("micro_batch", [64, 96])
def test_sharded_compact_walk(jx, cpu_mesh, micro_batch):
    """Each shard compacts its own survivors: verdicts equal the dense
    single-device run."""
    _both(jx, micro_batch=micro_batch, mesh=cpu_mesh, compact=True)


def test_sharded_walk_runs_on_every_shard(jx, cpu_mesh, monkeypatch):
    """The walk runs once per non-empty shard of each chunk, on that
    shard's rows in order (8 walks a chunk at micro-batch 64; the last
    chunk of 840 - 13 * 64 = 8 rows has one row a device)."""
    from repro_torch.serve import streaming
    sizes = []
    real = streaming.partition_walk

    def spy(x, *a, **kw):
        sizes.append(x.shape[0])
        return real(x, *a, **kw)

    monkeypatch.setattr(streaming, "partition_walk", spy)
    res = run_streaming(jx.eng, jx.wp, options=EngineOptions(
        micro_batch=64, mesh=cpu_mesh))
    _assert_same(res, jx.full)
    B = jx.wp.shape[0]
    want = [b - a for lo, hi in microbatches(B, 64)
            for a, b in flow_shards(hi - lo, 8) if b > a]
    assert sizes == want and max(sizes) == 8 and sum(sizes) == B


def test_engine_tables_replicas_are_cached():
    ds = make_dataset("d2", n_flows=120, seed=5)
    pdt = train_partitioned_dt(window_features(ds, 2, device="cpu"),
                               ds.labels, partition_sizes=[2, 2], k=3)
    eng = Engine.from_model(pdt, device="cpu")
    assert eng.tables_on("cpu") is eng.tables.dev
    assert eng._replicas == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hop kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def port_model():
    """A model trained by the port alone (the card's machine has no JAX):
    d2, 3,000 flows, (2, 3, 2), k = 4, its windows and the CPU walk."""
    ds = make_dataset("d2", n_flows=3000, seed=3)
    pdt = train_partitioned_dt(window_features(ds, 3, device="cpu"),
                               ds.labels, partition_sizes=[2, 3, 2], k=4)
    wp = window_packets(ds, 3)
    cpu = Engine.from_model(pdt, device="cpu").run(wp, with_trace=False)
    return pdt, wp, cpu


@pytest.mark.gpu
@pytest.mark.parametrize("inflight", [1, 2, 3])
@pytest.mark.parametrize("ragged", [False, True])
def test_streamed_verdicts_on_card_equal_cpu(card, port_model, inflight,
                                             ragged):
    from repro_torch.kernels import engine_hop as eh
    pdt, wp, cpu = port_model
    eng = Engine.from_model(pdt, device=card)
    n = wp.shape[0] - (37 if ragged else 0)
    mb = 256
    before = eh.launches
    res = run_streaming(eng, wp[:n], options=EngineOptions(
        micro_batch=mb, inflight=inflight))
    assert eh.launches - before == eng.tables.n_partitions * -(-n // mb)
    for name in ("labels", "recircs", "exit_partition"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(cpu, name)[:n])
    for donate in (False, True):
        res = run_streaming(eng, wp[:n], options=EngineOptions(
            micro_batch=mb, inflight=inflight, donate=donate, compact=True,
            mesh=make_flow_mesh(1)))
        for name in ("labels", "recircs", "exit_partition"):
            np.testing.assert_array_equal(getattr(res, name),
                                          getattr(cpu, name)[:n])


@pytest.mark.gpu
def test_stream_ring_holds_inflight_chunks_not_the_batch(card, port_model):
    """The device memory of a streamed call is that of ``inflight``
    chunks: the ring of inflight (micro_batch, P, W, 6) f32 buffers plus
    each chunk's walk buffers, far below the batch's windows."""
    pdt, wp, cpu = port_model
    eng = Engine.from_model(pdt, device=card)
    big = np.tile(wp, (16, 1, 1, 1))              # 48,000 flows
    mb, inflight = 1024, 2
    P, W = eng.tables.n_partitions, big.shape[2]
    ring = inflight * mb * P * W * 6 * 4
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = run_streaming(eng, big, options=EngineOptions(
        micro_batch=mb, inflight=inflight))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    assert ring <= peak <= ring + inflight * mb * 64 + (1 << 20)
    assert peak < big[:, :P].nbytes / 8
    np.testing.assert_array_equal(res.labels, np.tile(cpu.labels, 16))
