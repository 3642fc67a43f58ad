"""Live flow-table serving in the port vs the JAX package, at zero tolerance.

The per-packet fold's plain versions, the packet streams, the tick engine
(``init_tick_state``, ``admit_rows``, one ``tick_step`` from a JAX
mid-stream state) and ``FlowTableServer`` end to end, each held against
the JAX package on the same numpy inputs.  The JAX side runs its plain
oracles and its Pallas kernels in interpret mode; the port runs its plain
PyTorch versions on the CPU (the CUDA fold kernels are held against those
same plain versions on the card, in ``test_torch_package.py`` and
``chip_smoke.py``).  Every comparison is ``assert_array_equal``, which
allows only the sign of a zero to differ (docs/PARITY.md §5).
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference; where it is not installed (the card's
# machine) only test_torch_package.py runs
jnp = pytest.importorskip("jax.numpy")

import repro.kernels.tick_step as j_tick  # noqa: E402
from repro.core.inference import Engine as JEngine  # noqa: E402
from repro.core.inference import EngineOptions as JOptions  # noqa: E402
from repro.flows.synthetic import PacketBatch as JPacketBatch  # noqa: E402
from repro.flows.synthetic import make_packet_stream as j_make_stream  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.feature_window import (  # noqa: E402
    feature_update_at as j_feature_update_at,
    feature_update_finalize_pallas,
    feature_update_pallas,
)
from repro.serve import FlowTableServer as JServer  # noqa: E402
from repro.serve import StreamVerdicts as JVerdicts  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    engine_tables_from_arrays, tick_state_from_arrays,
)
from repro_torch.core import features as F  # noqa: E402
from repro_torch.core.inference import Engine, EngineOptions  # noqa: E402
from repro_torch.flows.synthetic import (  # noqa: E402
    PacketBatch, make_packet_stream,
)
from repro_torch.flows.windows import window_packets  # noqa: E402
from repro_torch.kernels import feature_window as fw  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tick_step as t_tick  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FlowTableServer, ServerStats, StreamVerdict, StreamVerdicts,
)

P = 3

# values whose f32 sums depend on the order they are added in; 3e20
# squares to inf, so (v * v) * m is NaN where m = 0
_SPIKY = np.asarray([1.0, 1e8, -1e8, 3.25, -0.0, 1500.0, 40.0, 7e-4,
                     16777216.0, 1.0e-30, 3.0e20], np.float32)
_SQ_FINITE = _SPIKY[np.abs(_SPIKY) < 1e19]


# ---------------------------------------------------------------------------
# the fold's plain versions
# ---------------------------------------------------------------------------
def _slot_rows(rng, n: int, k: int):
    """op/field/pred/init rows covering every op and predicate code and
    out-of-range field codes."""
    op = rng.integers(0, F.N_OPS, (n, k)).astype(np.int32)
    op.flat[:F.N_OPS] = np.arange(F.N_OPS)         # every op, OP_NONE too
    field = rng.integers(-1, F.PKT_NFIELDS + 2, (n, k)).astype(np.int32)
    pred = rng.integers(0, F.N_PREDS + 1, (n, k)).astype(np.int32)
    pred.flat[:F.N_PREDS] = np.arange(F.N_PREDS)   # every predicate
    init = np.where(rng.random((n, k)) < 0.5, np.finfo(np.float32).max,
                    rng.normal(size=(n, k))).astype(np.float32)
    return op, field, pred, init


def _packets(rng, shape, values):
    """Packet rows of ``shape + (PKT_NFIELDS,)`` with order-sensitive
    sizes and IATs; a fifth of the rows invalid."""
    pk = np.zeros(shape + (F.PKT_NFIELDS,), np.float32)
    pk[..., F.PKT_TS] = rng.exponential(0.01, shape)
    pk[..., F.PKT_SIZE] = rng.choice(values, shape)
    pk[..., F.PKT_DIR] = rng.integers(0, 2, shape)
    pk[..., F.PKT_FLAGS] = rng.integers(0, 64, shape)
    pk[..., F.PKT_IAT] = np.where(rng.random(shape) < 0.5,
                                  rng.choice(values, shape),
                                  rng.exponential(0.01, shape))
    pk[..., F.PKT_VALID] = rng.random(shape) < 0.8
    return pk


def _fold_inputs(seed: int, n: int, k: int, values=_SPIKY):
    """One packet per row plus a mid-window ``(acc, seen)`` state: blank
    rows (the ∓inf identities), rows that saw packets, invalid packets."""
    rng = np.random.default_rng(seed)
    pkt = _packets(rng, (n,), values)
    pkt[::5, F.PKT_VALID] = 0.0
    op, field, pred, init = _slot_rows(rng, n, k)
    acc0, _ = jref.feature_state_init(jnp.asarray(op))
    seen = (rng.random((n, k)) < 0.5).astype(np.int32)
    acc = np.where(seen > 0, rng.choice(values, (n, k)),
                   np.asarray(acc0)).astype(np.float32)
    return pkt, op, field, pred, init, acc, seen


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


@pytest.mark.parametrize("n,k", [(1, 4), (37, 4), (29, 41)])
def test_feature_state_init_matches_jax(n, k):
    op = np.random.default_rng(n).integers(0, F.N_OPS, (n, k)).astype(
        np.int32)
    _assert_all_equal(tref.feature_state_init(torch.from_numpy(op)),
                      jref.feature_state_init(jnp.asarray(op)))


@pytest.mark.parametrize("n,k", [(1, 4), (37, 4), (29, 41), (300, 4)])
def test_feature_update_ref_matches_jax(n, k):
    pkt, op, field, pred, _, acc, seen = _fold_inputs(n * 10 + k, n, k)
    args = (pkt, op, field, pred, acc, seen)
    _assert_all_equal(tref.feature_update_ref(*_torch(*args)),
                      jref.feature_update_ref(*map(jnp.asarray, args)))


@pytest.mark.parametrize("n,k", [(1, 4), (37, 4), (29, 41), (300, 4)])
def test_feature_update_finalize_ref_matches_jax(n, k):
    pkt, op, field, pred, init, acc, seen = _fold_inputs(n * 10 + k + 1, n, k)
    args = (pkt, op, field, pred, init, acc, seen)
    _assert_all_equal(tref.feature_update_finalize_ref(*_torch(*args)),
                      jref.feature_update_finalize_ref(
                          *map(jnp.asarray, args)))
    # finalize alone, on the folded state
    a2, s2, _ = tref.feature_update_finalize_ref(*_torch(*args))
    _assert_all_equal(
        (tref.feature_finalize_ref(a2, s2, *_torch(op, init)),),
        (jref.feature_finalize_ref(*map(jnp.asarray, (a2.numpy(), s2.numpy(),
                                                      op, init))),))


@pytest.mark.parametrize("n,k", [(37, 4), (29, 41), (130, 4)])
def test_fold_refs_match_pallas_interpret(n, k):
    pkt, op, field, pred, init, acc, seen = _fold_inputs(
        n + k, n, k, values=_SQ_FINITE)
    want = feature_update_pallas(*map(jnp.asarray, (pkt, op, field, pred,
                                                    acc, seen)),
                                 interpret=True, block_b=8)
    _assert_all_equal(
        tref.feature_update_ref(*_torch(pkt, op, field, pred, acc, seen)),
        want)
    want = feature_update_finalize_pallas(
        *map(jnp.asarray, (pkt, op, field, pred, init, acc, seen)),
        interpret=True, block_b=8)
    _assert_all_equal(tref.feature_update_finalize_ref(
        *_torch(pkt, op, field, pred, init, acc, seen)), want)


@pytest.mark.parametrize("B,W,k", [(37, 1, 4), (37, 7, 41), (29, 65, 4)])
def test_window_folded_packet_by_packet_equals_window_ref(B, W, k):
    """docs/PARITY.md §5: folding a window one packet at a time, from the
    blank state, and finalizing gives the rebuilt window's registers
    (padding packets included: a correct fold treats them as no-ops)."""
    rng = np.random.default_rng(B + W + k)
    pk = _packets(rng, (B, W), _SPIKY)
    pk[::5, :, F.PKT_VALID] = 0.0                  # all-invalid windows
    op, field, pred, init = _torch(*_slot_rows(rng, B, k))
    pk = torch.from_numpy(pk)
    want = tref.feature_window_ref(pk, op, field, pred, init)
    acc, seen = tref.feature_state_init(op)
    for t in range(W):
        a2, s2 = tref.feature_update_ref(pk[:, t].contiguous(), op, field,
                                         pred, acc, seen)
        fa, fs, regs = tref.feature_update_finalize_ref(
            pk[:, t].contiguous(), op, field, pred, init, acc, seen)
        _assert_all_equal((fa, fs), (a2.numpy(), s2.numpy()))
        acc, seen = a2, s2
    np.testing.assert_array_equal(regs.numpy(), want.numpy())
    np.testing.assert_array_equal(
        tref.feature_finalize_ref(acc, seen, op, init).numpy(), want.numpy())


def test_per_op_fold_entry_points_take_the_plain_version_on_cpu():
    pkt, op, field, pred, init, acc, seen = _fold_inputs(4, 50, 4)
    t = _torch(pkt, op, field, pred, init, acc, seen)
    before = (fw.update_launches, fw.update_finalize_launches)
    _assert_all_equal(tops.feature_update(*t[:4], *t[5:]),
                      [x.numpy() for x in tref.feature_update_ref(
                          *t[:4], *t[5:])])
    _assert_all_equal(tops.feature_update_finalize(*t),
                      [x.numpy() for x in tref.feature_update_finalize_ref(
                          *t)])
    assert (fw.update_launches, fw.update_finalize_launches) == before


def test_feature_update_at_matches_jax_in_place():
    """Gather rows -> fold -> scatter, updating the table in place; the
    dummy-padded duplicates (row N) fold identical values."""
    N, k, n = 40, 4, 16
    rng = np.random.default_rng(8)
    pkt, op, field, pred, _, _, _ = _fold_inputs(9, n, k, values=_SQ_FINITE)
    acc_tab = rng.choice(_SQ_FINITE, (N + 1, k)).astype(np.float32)
    seen_tab = rng.integers(0, 2, (N + 1, k)).astype(np.int32)
    slots = np.full(n, N, np.int32)
    slots[:10] = rng.permutation(N)[:10]
    pkt[10:] = 0.0                                 # padding: invalid rows
    op[10:], field[10:], pred[10:] = op[0], field[0], pred[0]
    want = j_feature_update_at(
        *map(jnp.asarray, (acc_tab, seen_tab, slots, pkt, op, field, pred)),
        interpret=True, block_b=8)
    a, s = _torch(acc_tab.copy(), seen_tab.copy())
    got = fw.feature_update_at(a, s, *_torch(slots, pkt, op, field, pred))
    assert got[0] is a and got[1] is s             # updated in place
    _assert_all_equal(got, want)


# ---------------------------------------------------------------------------
# packet streams and the tick engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_setup(trained_pdt):
    """The JAX engine of the shared ``trained_pdt`` fixture, the port's
    engine over the very same device tables (``convert``), and one packet
    stream over the training split."""
    pdt, _, tr = trained_pdt
    jeng = JEngine.from_model(pdt)
    arrays = {n: np.asarray(getattr(jeng.dev, n)) for n in jeng.dev._fields}
    eng = Engine.from_tables(engine_tables_from_arrays(
        arrays, n_subtrees=jeng.ret.n_subtrees,
        n_partitions=pdt.n_partitions, n_classes=jeng.ret.n_classes,
        device="cpu"))
    stream = make_packet_stream(tr, seed=11, profile="steady")
    return jeng, eng, tr, stream


@pytest.mark.parametrize("profile,seed,concurrency",
                         [("steady", 11, 32.0), ("bursty", 5, 8.0)])
def test_make_packet_stream_bit_for_bit(serve_setup, profile, seed,
                                        concurrency):
    _, _, tr, _ = serve_setup
    a = make_packet_stream(tr, seed=seed, profile=profile,
                           concurrency=concurrency)
    b = j_make_stream(tr, seed=seed, profile=profile,
                      concurrency=concurrency)
    for name in ("flow_id", "flow_len", "pkts", "arrival", "labels"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.profile == b.profile and a.n_packets == b.n_packets
    for x, y in zip(a.ticks(997), b.ticks(997)):
        assert isinstance(x, PacketBatch) and x.n_packets == y.n_packets
        np.testing.assert_array_equal(x.pkts, y.pkts)
    with pytest.raises(ValueError):
        next(a.ticks(0))
    with pytest.raises(ValueError, match="profile"):
        make_packet_stream(tr, profile="diurnal")


def _state_arrays(state) -> dict:
    return {name: np.asarray(getattr(state, name))
            for name in state._fields}


def _assert_state_equal(got: t_tick.TickState, want, rows=slice(None)):
    for name in t_tick.TickState._fields:
        g = getattr(got, name)
        w = np.asarray(getattr(want, name))
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy()[rows], w[rows], err_msg=name)


def test_init_tick_state_and_admit_rows_match_jax(serve_setup):
    jeng, eng, _, _ = serve_setup
    N = 40
    st = t_tick.init_tick_state(eng.tables.dev, N + 1, P)
    jst = j_tick.init_tick_state(jeng.dev, N + 1, P)
    _assert_state_equal(st, jst)
    # admit 11 slots (lengths 1 .. 200, shorter than P included) and pad
    # with the dummy row at length 1, as the server does
    rng = np.random.default_rng(3)
    slots = np.full(16, N, np.int32)
    slots[:11] = rng.permutation(N)[:11]
    lengths = np.ones(16, np.int32)
    lengths[:11] = [1, 2, 3, 4, 5, 7, 64, 65, 66, 199, 200]
    # dirty the rows first: admission must reset a recycled slot fully
    st.acc.fill_(7.0)
    st.sid.fill_(3)
    jst = jst._replace(acc=jnp.full_like(jst.acc, 7.0),
                       sid=jnp.full_like(jst.sid, 3))
    got = t_tick.admit_rows(st, *_torch(slots, lengths), eng.tables.dev)
    assert got is st                               # updated in place
    want = j_tick.admit_rows(jst, jnp.asarray(slots), jnp.asarray(lengths),
                             jeng.dev)
    _assert_state_equal(got, want)


def test_tick_state_from_arrays_checks_fields():
    st = t_tick.init_tick_state(_tiny_dev(), 9, P)
    arrays = {name: getattr(st, name).numpy() for name in st._fields}
    back = tick_state_from_arrays(arrays, device="cpu")
    for name in st._fields:
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    with pytest.raises(ValueError, match="pkts_seen"):
        tick_state_from_arrays(
            dict(arrays, pkts_seen=arrays["pkts_seen"].astype(np.int64)),
            device="cpu")
    with pytest.raises(ValueError, match="bounds"):
        tick_state_from_arrays(dict(arrays, bounds=arrays["bounds"][:-1]),
                               device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tick_state_from_arrays({k: v for k, v in arrays.items()
                                if k != "retired"}, device="cpu")


def _tiny_dev():
    from repro_torch.kernels.ops import DeviceTables
    i32 = torch.int32
    return DeviceTables(
        torch.tensor([[3, 4]], dtype=i32), torch.zeros(1, 2, dtype=i32),
        torch.zeros(1, 2, dtype=i32), torch.zeros(1, 2),
        torch.zeros(1, 2, 4), torch.zeros(1, 2, 2, dtype=i32),
        torch.zeros(1, 2, 2, dtype=i32), torch.zeros(1, 2, dtype=i32),
        torch.zeros(1, 2, dtype=i32))


@pytest.fixture(scope="module")
def jax_tick_call(serve_setup):
    """One fused tick of the JAX server, captured mid-stream: its input
    state, its rank-major packing and its outputs.  The tick taken is the
    one that emitted the most verdicts."""
    jeng, _, tr, _ = serve_setup
    stream = j_make_stream(tr, seed=11, profile="steady")
    calls = []
    orig = j_tick.tick_step

    def record(state, slots_rc, pkt_rc, dev, **kw):
        out = orig(state, slots_rc, pkt_rc, dev, **kw)
        calls.append((state, np.asarray(slots_rc), np.asarray(pkt_rc), out))
        return out

    srv = JServer(jeng, n_buckets=8, bucket_size=4, tick_engine="fused",
                  options=JOptions(impl="fused"))
    j_tick.tick_step = record
    try:
        for batch in stream.ticks(300):
            srv.ingest(batch)
            if len(calls) >= 12:
                break
    finally:
        j_tick.tick_step = orig
    best = max(calls, key=lambda c: int(np.asarray(c[3][1][0]).sum()))
    assert best[1].shape[0] > 1                    # several ranks
    assert int(np.asarray(best[3][1][0]).sum()) > 0  # verdicts this tick
    return best, srv.S


@pytest.mark.parametrize("pallas", [False, True])
def test_tick_step_from_jax_state_matches_jax(serve_setup, jax_tick_call,
                                              pallas):
    """The port steps the JAX server's own mid-stream state (carried by
    ``tick_state_from_arrays``) through the same packed tick: rows
    ``[:N]`` of every field and the five verdict arrays equal JAX's, with
    the dense step (``pallas=False``) and the Pallas step in interpret
    mode (``pallas=True``)."""
    jeng, eng, _, _ = serve_setup
    (jstate, slots_rc, pkt_rc, _), S = jax_tick_call
    want_state, want_v = j_tick.tick_step(
        jstate, jnp.asarray(slots_rc), jnp.asarray(pkt_rc), jeng.dev,
        n_subtrees=S, pallas=pallas, block_b=8)
    st = tick_state_from_arrays(_state_arrays(jstate), device="cpu")
    got_state, got_v = t_tick.tick_step(
        st, *_torch(slots_rc, pkt_rc), eng.tables.dev, n_subtrees=S,
        cuda=False)
    N = jstate.sid.shape[0] - 1                    # the dummy row
    _assert_state_equal(got_state, want_state, rows=slice(0, N))
    _assert_all_equal(got_v, want_v)


def test_tick_step_on_cpu_refuses_nothing_and_launches_nothing(serve_setup):
    """``cuda=False`` is the plain route: no kernel launches."""
    _, eng, _, _ = serve_setup
    st = t_tick.init_tick_state(eng.tables.dev, 9, P)
    t_tick.admit_rows(st, *_torch(np.arange(8, dtype=np.int32),
                                  np.full(8, 5, np.int32)), eng.tables.dev)
    before = fw.update_finalize_launches
    slots = torch.arange(8, dtype=torch.int32)[None].repeat(5, 1)
    pkt = torch.zeros(5, 8, F.PKT_NFIELDS)
    pkt[..., F.PKT_VALID] = 1.0
    _, (vm, vl, vr, ve, rec) = t_tick.tick_step(
        st, slots, pkt, eng.tables.dev, n_subtrees=eng.tables.n_subtrees,
        cuda=False)
    assert int(vm.sum()) == 8                      # every flow completed
    assert all(v.dtype == torch.int32 and v.shape == (8,)
               for v in (vm, vl, vr, ve, rec))
    assert fw.update_finalize_launches == before


# ---------------------------------------------------------------------------
# FlowTableServer end to end, against the JAX server
# ---------------------------------------------------------------------------
def _values(snapshot: dict) -> dict:
    """A registry snapshot without the help strings."""
    return {kind: {name: {k: v for k, v in m.items() if k != "help"}
                   for name, m in metrics.items()}
            for kind, metrics in snapshot.items()}


def _assert_calls_equal(got: list, want: list):
    """Every ``StreamVerdicts`` of every call, row by row in order."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("flow_id", "labels", "recircs", "exit_partition"):
            x, y = getattr(g, name), getattr(w, name)
            assert x.dtype == y.dtype, (i, name)
            np.testing.assert_array_equal(x, y, err_msg=f"call {i}: {name}")


def _run_both(jeng, eng, tick_engine: str, script, **kw):
    """Drive a JAX server and a port server through the same calls;
    ``script(srv, package)`` yields each call's ``StreamVerdicts``."""
    jsrv = JServer(jeng, tick_engine=tick_engine,
                   options=JOptions(impl="fused"), **kw)
    srv = FlowTableServer(eng, tick_engine=tick_engine, **kw)
    want = list(script(jsrv, "jax"))
    got = list(script(srv, "torch"))
    _assert_calls_equal(got, want)
    assert srv.stats.as_dict() == jsrv.stats.as_dict()
    assert _values(srv.registry.snapshot()) == _values(
        jsrv.registry.snapshot())
    return srv, got


def _stream_of(tr, package, **kw):
    return (j_make_stream if package == "jax" else make_packet_stream)(
        tr, **kw)


def _batch(package, fid, flen, pkts, arr):
    return (JPacketBatch if package == "jax" else PacketBatch)(
        fid, flen, pkts, arr)


_TABLES = {
    # name: (server knobs, tick size)
    "steady": (dict(n_buckets=8, bucket_size=4), 211),
    "spill+timeout": (dict(n_buckets=2, bucket_size=2, timeout=0.005), 1500),
}


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
@pytest.mark.parametrize("table", sorted(_TABLES))
def test_server_matches_jax(serve_setup, table, tick_engine):
    """The whole stream then ``flush``: every call's verdicts, the stats
    and the registry equal the JAX server's.  The tiny table spills most
    flows to the host store, and the timeout evicts flows mid-window."""
    jeng, eng, tr, _ = serve_setup
    knobs, tick = _TABLES[table]

    def script(srv, package):
        for batch in _stream_of(tr, package, seed=11).ticks(tick):
            yield srv.ingest(batch)
        yield srv.flush()

    srv, got = _run_both(jeng, eng, tick_engine, script, **knobs)
    v = StreamVerdicts.concat(got)
    assert v.n_flows == tr.n_flows and np.unique(v.flow_id).size == v.n_flows
    assert srv.stats.spilled > 0
    if "timeout" in knobs:
        assert srv.stats.evicted > 0 and v.n_unterminated > 0


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_server_flush_mid_window_and_late_packets_match_jax(serve_setup,
                                                            tick_engine):
    """Half the stream, a flush mid-window (-1 sentinels), the rest of
    the stream (the flushed flows' later packets are dropped), then the
    whole stream again: every flow is retired by then, so every packet
    is dropped and nothing more is emitted."""
    jeng, eng, tr, _ = serve_setup

    def script(srv, package):
        stream = _stream_of(tr, package, seed=11)
        half = stream.n_packets // 2
        yield srv.ingest(stream.slice(0, half))
        yield srv.flush()
        yield srv.ingest(stream.slice(half, stream.n_packets))
        yield srv.flush()
        for batch in stream.ticks(4000):
            yield srv.ingest(batch)
        yield srv.flush()

    _, got = _run_both(jeng, eng, tick_engine, script, n_buckets=8,
                       bucket_size=4)
    assert got[1].n_flows > 0 and (got[1].labels == -1).all()
    v = StreamVerdicts.concat(got)
    assert v.n_flows == tr.n_flows and np.unique(v.flow_id).size == v.n_flows
    assert sum(v.n_flows for v in got[4:]) == 0


def _whole_flows(tr, package, sel, t0=0.0, extra_tail=0):
    """One tick delivering each selected flow IN FULL, then optionally
    ``extra_tail`` copies of the first flow's last packet (late packets
    past its length)."""
    sel = list(sel)
    fid = np.concatenate([np.full(int(tr.lengths[i]), i, np.int64)
                          for i in sel])
    pkts = np.concatenate([tr.packets[i, :int(tr.lengths[i])] for i in sel])
    if extra_tail:
        i = sel[0]
        last = tr.packets[i, int(tr.lengths[i]) - 1][None]
        fid = np.concatenate([fid, np.full(extra_tail, i, np.int64)])
        pkts = np.concatenate([pkts, np.repeat(last, extra_tail, axis=0)])
    return _batch(package, fid, tr.lengths[fid].astype(np.int32),
                  pkts.astype(np.float32),
                  t0 + np.arange(fid.size, dtype=np.float64))


def _recycled_slots(tr):
    """A capacity-1 table fed whole flows with ``rank_floor=1``: each
    tick completes its resident flow mid-tick (the deepest rank chain),
    frees the slot for the next tick's flow, and spills the companion."""
    def script(srv, package):
        for i in range(0, 16, 2):
            yield srv.ingest(_whole_flows(tr, package, (i, i + 1),
                                          t0=1e3 * i))
        yield srv.flush()
    return dict(n_buckets=1, bucket_size=1, rank_floor=1), script


def _interleaved_boundaries(tr):
    """16 flows round-robin in ONE tick: every window boundary, hop and
    drain round lands mid-tick, many flows completing in the same rank."""
    sel = list(range(40, 56))
    rows = [(i, j) for j in range(max(int(tr.lengths[i]) for i in sel))
            for i in sel if j < int(tr.lengths[i])]
    fid = np.asarray([i for i, _ in rows], np.int64)
    pkts = np.asarray([tr.packets[i, j] for i, j in rows], np.float32)

    def script(srv, package):
        yield srv.ingest(_batch(package, fid,
                                tr.lengths[fid].astype(np.int32), pkts,
                                np.arange(fid.size, dtype=np.float64)))
        yield srv.flush()
    return dict(n_buckets=4, bucket_size=4), script


def _late_packets(tr):
    """Late duplicates of a completed flow in the same tick and in the
    next one must not fold into the slot's next tenant; then a tick far
    later evicts every idle flow on a timeout."""
    a, b = 3, 5

    def script(srv, package):
        yield srv.ingest(_whole_flows(tr, package, [a], extra_tail=3))
        t2 = _whole_flows(tr, package, [b], t0=1e6)
        late = tr.packets[a, int(tr.lengths[a]) - 2:int(tr.lengths[a])]
        yield srv.ingest(_batch(
            package, np.concatenate([t2.flow_id, np.full(2, a, np.int64)]),
            np.concatenate([t2.flow_len,
                            tr.lengths[[a, a]].astype(np.int32)]),
            np.concatenate([t2.pkts, late]),
            np.arange(t2.flow_id.size + 2, dtype=np.float64) + 1e6))
        stream = _stream_of(tr, package, seed=11)
        yield srv.ingest(stream.slice(0, 64))
        yield srv.ingest(stream.slice(stream.n_packets - 8,
                                      stream.n_packets))
        yield srv.flush()
    return dict(n_buckets=1, bucket_size=1, timeout=1.0), script


def _short_flows(tr):
    """Flows of 1 and 2 packets (fewer than P = 3): their trailing
    windows are empty, so every one drains inside the tick that brings
    its last packet; some arrive interleaved with two full flows."""
    sel = list(range(60, 76))
    flen = {i: 1 + i % 2 for i in sel}
    flen.update({80: int(tr.lengths[80]), 81: int(tr.lengths[81])})
    order = sorted(flen)
    rows = [(i, j) for j in range(max(flen.values())) for i in order
            if j < flen[i]]
    fid = np.asarray([i for i, _ in rows], np.int64)
    pkts = np.asarray([tr.packets[i, j] for i, j in rows], np.float32)
    lens = np.asarray([flen[i] for i in fid], np.int32)

    def script(srv, package):
        half = fid.size // 2
        for lo, hi in ((0, half), (half, fid.size)):
            yield srv.ingest(_batch(package, fid[lo:hi], lens[lo:hi],
                                    pkts[lo:hi],
                                    np.arange(lo, hi, dtype=np.float64)))
        yield srv.flush()
    return dict(n_buckets=8, bucket_size=4), script


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_server_recycled_slots_rank_floor_1_match_jax(serve_setup,
                                                      tick_engine):
    """See :func:`_recycled_slots`."""
    jeng, eng, tr, _ = serve_setup
    knobs, script = _recycled_slots(tr)
    srv, _ = _run_both(jeng, eng, tick_engine, script, **knobs)
    assert srv.stats.spilled > 0


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_server_interleaved_boundary_hops_match_jax(serve_setup, tick_engine):
    """See :func:`_interleaved_boundaries`."""
    jeng, eng, tr, _ = serve_setup
    knobs, script = _interleaved_boundaries(tr)
    _run_both(jeng, eng, tick_engine, script, **knobs)


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_server_late_packets_and_timeout_match_jax(serve_setup, tick_engine):
    """See :func:`_late_packets`."""
    jeng, eng, tr, _ = serve_setup
    knobs, script = _late_packets(tr)
    srv, got = _run_both(jeng, eng, tick_engine, script, **knobs)
    assert got[0].n_flows == 1 and srv.stats.evicted > 0


@pytest.mark.parametrize("tick_engine", ["fused", "legacy"])
def test_server_short_flows_match_jax(serve_setup, tick_engine):
    """See :func:`_short_flows`."""
    jeng, eng, tr, _ = serve_setup
    knobs, script = _short_flows(tr)
    _, got = _run_both(jeng, eng, tick_engine, script, **knobs)
    v = StreamVerdicts.concat(got)
    assert v.n_flows == 18 and sum(c.n_flows for c in got[:2]) == 18


# ---------------------------------------------------------------------------
# the tick kernel's control flow, column by column, against JAX
# ---------------------------------------------------------------------------
_F32 = np.float32


def _fold_slot(op, m: bool, v, acc, seen: int):
    """``csrc/fold.cuh`` fold_slot on numpy f32 scalars (each product and
    sum rounded to f32, as __fmul_rn/__fadd_rn)."""
    mf = _F32(1.0) if m else _F32(0.0)
    if op == F.OP_COUNT:
        acc = _F32(acc + mf)
    elif op == F.OP_SUM:
        acc = _F32(acc + _F32(v * mf))
    elif op == F.OP_SUMSQ:
        acc = _F32(acc + _F32(_F32(v * v) * mf))
    elif op == F.OP_MAX and m:
        acc = np.maximum(acc, v)
    elif op == F.OP_MIN and m:
        acc = np.minimum(acc, v)
    elif op == F.OP_FIRST and m and seen == 0:
        acc = v
    elif op == F.OP_LAST and m:
        acc = v
    return acc, seen | int(m)


def _pred(pk, pred: int) -> bool:
    if not pk[F.PKT_VALID] > 0:
        return False
    flags = int(pk[F.PKT_FLAGS])
    bits = dict(F.PRED_FLAGS)
    if pred == F.PRED_TRUE:
        return True
    if pred == F.PRED_FWD:
        return pk[F.PKT_DIR] == 0
    if pred == F.PRED_BWD:
        return pk[F.PKT_DIR] == 1
    return pred in bits and (flags & bits[pred]) > 0


def _walk_hop(st, slot, dev, verdicts, n_subtrees):
    """Finalize, range-match and hop one slot (``Flow::hop``); returns
    whether it advanced into an empty window."""
    vm, vl, vr, ve = verdicts
    P = st["bounds"].shape[1]
    s = st["sid"][slot]                  # -1 reads the last row, as in C
    op, init = dev["slot_op"][s], dev["slot_init"][s]
    regs = [_F32(0.0) if st["seen"][slot, j] == 0 and op[j] in (
                F.OP_MAX, F.OP_FIRST, F.OP_LAST)
            else init[j] if st["seen"][slot, j] == 0 and op[j] == F.OP_MIN
            else st["acc"][slot, j] for j in range(op.size)]
    marks = [int((r > dev["thresholds"][s, j]).sum())
             for j, r in enumerate(regs)]
    action = -1
    for leaf in range(dev["leaf_lo"].shape[1]):
        if dev["leaf_valid"][s, leaf] > 0 and all(
                dev["leaf_lo"][s, leaf, j] <= m <= dev["leaf_hi"][s, leaf, j]
                for j, m in enumerate(marks)):
            action = int(dev["leaf_action"][s, leaf])
            break
    adv = False
    if action >= n_subtrees:
        vm[slot], vl[slot] = 1, action - n_subtrees
        vr[slot], ve[slot] = st["recircs"][slot], st["part"][slot]
        st["retired"][slot] = 1
    else:
        st["recircs"][slot] += 1
        st["sid"][slot] = action
        if st["part"][slot] == P - 1:
            vm[slot], vl[slot] = 1, -1
            vr[slot], ve[slot] = st["recircs"][slot], -1
            st["retired"][slot] = 1
        else:
            adv = True
            st["part"][slot] += 1
            st["win_lo"][slot], st["win_hi"][slot] = \
                st["bounds"][slot, st["part"][slot]]
    new_op = dev["slot_op"][st["sid"][slot]]
    st["acc"][slot] = np.where(new_op == F.OP_MIN, np.inf, np.where(
        new_op == F.OP_MAX, -np.inf, 0.0)).astype(np.float32)
    st["seen"][slot] = 0
    return adv and st["win_lo"][slot] == st["win_hi"][slot]


def _walk_tick(st: dict, slots_rc, pkt_rc, dev: dict, n_subtrees: int):
    """One tick the way ``csrc/tick_step.cu`` walks it: one column at a
    time, its ranks in order, each hop and drain round inline.  Updates
    the numpy state ``st`` in place; returns the four verdict buffers."""
    N1 = st["sid"].shape[0]
    dummy, P = N1 - 1, st["bounds"].shape[1]
    verdicts = (np.zeros(N1, np.int32), np.full(N1, -1, np.int32),
                np.zeros(N1, np.int32), np.full(N1, -1, np.int32))
    R, C = slots_rc.shape
    with np.errstate(all="ignore"):      # inf * 0 is NaN, as on the card
        for c in range(C):
            for r in range(R):
                slot = int(slots_rc[r, c])
                if slot == dummy or st["retired"][slot]:
                    continue
                pk = pkt_rc[r, c].copy()
                if st["pkts_seen"][slot] == st["win_lo"][slot]:
                    pk[F.PKT_IAT] = 0.0
                s = st["sid"][slot]
                for j in range(st["acc"].shape[1]):
                    f = dev["slot_field"][s, j]
                    v = pk[f] if 0 <= f < F.PKT_NFIELDS else _F32(0.0)
                    st["acc"][slot, j], st["seen"][slot, j] = _fold_slot(
                        dev["slot_op"][s, j],
                        _pred(pk, dev["slot_pred"][s, j]), v,
                        st["acc"][slot, j], st["seen"][slot, j])
                st["pkts_seen"][slot] += 1
                if st["pkts_seen"][slot] != st["win_hi"][slot]:
                    continue
                again = _walk_hop(st, slot, dev, verdicts, n_subtrees)
                for _ in range(P):
                    if not again:
                        break
                    again = _walk_hop(st, slot, dev, verdicts, n_subtrees)
    return verdicts


def _record_jax_ticks(jeng, script, **knobs):
    """Every fused tick the JAX server runs under ``script``: its input
    state, its rank-major packing and its outputs."""
    calls = []
    orig = j_tick.tick_step

    def record(state, slots_rc, pkt_rc, dev, **kw):
        out = orig(state, slots_rc, pkt_rc, dev, **kw)
        calls.append((state, np.asarray(slots_rc), np.asarray(pkt_rc), out))
        return out

    srv = JServer(jeng, tick_engine="fused", options=JOptions(impl="fused"),
                  **knobs)
    j_tick.tick_step = record
    try:
        for _ in script(srv, "jax"):
            pass
    finally:
        j_tick.tick_step = orig
    return calls


@pytest.mark.parametrize("case", ["mid_stream", "late_packets",
                                  "recycled_slots", "interleaved_boundaries",
                                  "short_flows"])
def test_column_walker_matches_jax_tick_step(serve_setup, jax_tick_call,
                                             case):
    """The tick kernel's control flow, walked on the CPU one column at a
    time (ranks in order, drain inline, the row math on f32 scalars),
    equals the JAX ``tick_step`` on every recorded tick: rows ``[:N]`` of
    every state field and the five verdict arrays, at zero tolerance."""
    jeng, _, tr, _ = serve_setup
    if case == "mid_stream":
        call, S = jax_tick_call
        calls = [call]
    else:
        knobs, script = globals()["_" + case](tr)
        calls = _record_jax_ticks(jeng, script, **knobs)
        S = jeng.ret.n_subtrees
    dev = {n: np.asarray(getattr(jeng.dev, n)) for n in jeng.dev._fields}
    assert calls
    for i, (jstate, slots_rc, pkt_rc, (want_state, want_v)) in \
            enumerate(calls):
        st = {n: a.copy() for n, a in _state_arrays(jstate).items()}
        N = st["sid"].shape[0] - 1
        vm, vl, vr, ve = _walk_tick(st, slots_rc, pkt_rc, dev, S)
        for name in t_tick.TickState._fields:
            np.testing.assert_array_equal(
                st[name][:N], np.asarray(getattr(want_state, name))[:N],
                err_msg=f"tick {i}: {name}")
        for j, (g, w) in enumerate(zip(
                (vm[:N], vl[:N], vr[:N], ve[:N], st["recircs"][:N]),
                want_v)):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"tick {i}: verdict {j}")


def test_streamed_verdicts_equal_engine_run(serve_setup):
    """The port's server against the port's own batch walk on the
    rebuilt windows: the flow table changes when a verdict comes, never
    its value."""
    _, eng, tr, stream = serve_setup
    full = eng.run(window_packets(tr, P), with_trace=False)
    srv = FlowTableServer(eng, n_buckets=16, bucket_size=8,
                          options=EngineOptions(impl="fused"))
    v = StreamVerdicts.concat([srv.ingest(b) for b in stream.ticks(700)]
                              + [srv.flush()])
    order = np.argsort(v.flow_id)
    np.testing.assert_array_equal(v.flow_id[order], np.arange(tr.n_flows))
    for name in ("labels", "recircs", "exit_partition"):
        np.testing.assert_array_equal(getattr(v, name)[order],
                                      getattr(full, name), err_msg=name)
    assert srv.stats.packets == stream.n_packets
    assert srv.last_tick_shape is not None
    # every fused tick is at most two logical device calls plus its spill
    # run: admission scatter, tick step
    assert srv.stats.dispatches <= 3 * srv.stats.ticks


def test_server_knobs(serve_setup):
    _, eng, _, _ = serve_setup
    # "auto", the default, resolves through the tick-shape estimate
    assert FlowTableServer(eng, tick_engine="auto").tick_engine == "fused"
    with pytest.raises(ValueError, match="unknown tick_engine"):
        FlowTableServer(eng, tick_engine="warp")
    for impl in ("auto", "tuned"):
        srv = FlowTableServer(eng, options=EngineOptions(impl=impl))
        assert srv._plan.backend == "fused" and not srv._cuda
    with pytest.raises(ValueError, match="CUDA device"):
        FlowTableServer(eng, options=EngineOptions(impl="cuda"))
    srv = FlowTableServer(eng)
    assert srv.tick_engine == "fused" and not srv._cuda
    assert StreamVerdict is StreamVerdicts
    e = StreamVerdicts.empty()
    assert e.n_flows == 0 and e.n_unterminated == 0
    one = StreamVerdicts(np.array([7], np.int64), np.array([2], np.int32),
                         np.array([1], np.int32), np.array([-1], np.int32))
    cat = StreamVerdicts.concat([e, one, one])
    assert cat.n_flows == 2 and cat.n_unterminated == 2
    assert StreamVerdicts.concat([]).n_flows == 0
    assert set(ServerStats().as_dict()) == set(ServerStats.FIELDS)
