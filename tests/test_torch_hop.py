"""The engine's hop (``csrc/engine_hop.cu``) and its plain version vs the
JAX package, at zero tolerance, on the CPU.

* ``ref.engine_hop_ref`` against JAX ``fused_step`` + ``_hop_update``,
  hop by hop, on every carry field and on the registers;
* a scalar mirror of the kernel's per-lane arithmetic (``window.cuh``'s
  predicate bits and statistics, the chains started at -0.0, then the
  range match and the carry update of ``engine_hop.cu``) against the same
  JAX functions, and against the port's plain version on subnormal fields,
  where XLA on the CPU flushes;
* the launch geometry of the window kernels (pure Python);
* the walk's fetch: its buffer layout, and results that own their arrays.

Inputs are made with numpy from a seed and handed to both packages.  The
kernel itself runs only on the card (``test_torch_package.py``, marker
``gpu``, and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference; where it is not installed (the card's
# machine) only test_torch_package.py runs
jnp = pytest.importorskip("jax.numpy")

from repro.core.inference import _hop_update as j_hop_update  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import features as F  # noqa: E402
from repro_torch.core import inference as inf  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.engine_hop import (  # noqa: E402
    engine_hop_plain, step_hop,
)
from repro_torch.kernels.ops import DeviceTables  # noqa: E402
from repro_torch.kernels.window import (  # noqa: E402
    STAGE_BYTES, STAGES, WINDOW_THREADS, window_geometry,
)

_F32 = np.float32
# order-sensitive values, -0.0 among them (no subnormals: XLA on the CPU
# flushes them, see test_subnormal_fields_keep_ieee_values)
_VALUES = np.asarray([1.0, 1e8, -1e8, 3.25, -0.0, -0.0, 1500.0, 40.0, 7e-4,
                      -7e-4, 16777216.0, 1.0e-30, -2.5, 0.0], np.float32)
_SUBNORMAL = np.asarray([1e-40, -2e-40, 3e-41, -1e-45, 1.17e-38, -0.0],
                        np.float32)


def _packets(rng, B: int, W: int, values=_VALUES):
    pk = np.zeros((B, W, F.PKT_NFIELDS), np.float32)
    pk[..., F.PKT_TS] = rng.choice(values, (B, W))
    pk[..., F.PKT_SIZE] = rng.choice(values, (B, W))
    pk[..., F.PKT_DIR] = rng.integers(0, 2, (B, W))
    pk[..., F.PKT_FLAGS] = rng.integers(0, 64, (B, W))
    pk[..., F.PKT_IAT] = rng.choice(values, (B, W))
    pk[..., F.PKT_VALID] = rng.random((B, W)) < 0.8
    pk[::5, :, F.PKT_VALID] = 0.0                     # empty windows
    return pk


def _tables(rng, S: int, k: int, T: int, L: int, n_classes: int = 4):
    """Random subtree tables: every op and predicate code, out-of-range
    field codes, +inf-padded thresholds among the packet values, leaves
    that recirculate (actions < S), exit (>= S) or are invalid."""
    op = rng.integers(0, F.N_OPS, (S, k)).astype(np.int32)
    op.flat[:F.N_OPS] = np.arange(F.N_OPS)
    field = rng.integers(-1, F.PKT_NFIELDS + 1, (S, k)).astype(np.int32)
    pred = rng.integers(0, F.N_PREDS + 1, (S, k)).astype(np.int32)
    init = np.where(rng.random((S, k)) < 0.5, np.finfo(np.float32).max,
                    rng.normal(size=(S, k))).astype(np.float32)
    thr = np.sort(rng.choice(np.r_[_VALUES, 2.0, 5.0, 64.0], (S, k, T)),
                  axis=2).astype(np.float32)
    thr[:, :, T - 2:] = np.inf
    # a slot's range is the whole [0, T] with probability 1 - 0.5 / k, so
    # about 60% of leaves ignore their marks at any k
    full = rng.random((S, L, k)) < 1 - 0.5 / k
    lo = np.where(full, 0, rng.integers(0, 3, (S, L, k))).astype(np.int32)
    hi = np.where(full, T, lo + rng.integers(0, T, (S, L, k))
                  ).astype(np.int32)
    action = rng.integers(0, S + n_classes, (S, L)).astype(np.int32)
    valid = (rng.random((S, L)) < 0.85).astype(np.int32)
    return op, field, pred, init, thr, lo, hi, action, valid


def _carry(rng, B: int, S: int):
    """SIDs over [0, S) plus some -1, a mix of done flows."""
    sid = rng.integers(-1, S, B).astype(np.int32)
    sid[:3] = -1
    done = rng.random(B) < 0.3
    labels = np.where(done, rng.integers(0, 4, B), -1).astype(np.int32)
    recircs = rng.integers(0, 3, B).astype(np.int32)
    exit_p = np.where(done, rng.integers(0, 2, B), -1).astype(np.int32)
    return sid, done, labels, recircs, exit_p


def _jax_hop(pk, carry, tables, p: int, S: int):
    jdev = jops.DeviceTables(*map(jnp.asarray, tables))
    jc = tuple(map(jnp.asarray, carry))
    regs, action = jops.fused_step(jnp.asarray(pk), jc[0], jdev)
    new = j_hop_update(jc, p, action, S)
    return tuple(np.asarray(a) for a in new), np.asarray(regs)


def _assert_hop_equal(got_carry, got_regs, want_carry, want_regs, where):
    for name, g, w in zip(("sid", "done", "labels", "recircs", "exit_p"),
                          got_carry, want_carry):
        g = np.asarray(g)
        assert g.dtype == w.dtype, (where, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {name}")
    np.testing.assert_array_equal(np.asarray(got_regs), want_regs,
                                  err_msg=f"{where}: regs")


# B = 37, 101: no multiple of any tile (256 / k flows a CTA)
@pytest.mark.parametrize("B,W,k", [(37, 1, 4), (101, 65, 4), (37, 9, 9),
                                   (29, 64, 41)])
def test_engine_hop_ref_matches_jax_hop_by_hop(B, W, k):
    rng = np.random.default_rng(B * 100 + W + k)
    S, T, L, P = 7, 6, 5, 3
    tables = _tables(rng, S, k, T, L)
    dev = DeviceTables(*map(torch.from_numpy, tables))
    carry = _carry(rng, B, S)
    win = _packets(rng, B, P * W).reshape(B, P, W, F.PKT_NFIELDS)
    t_carry = tuple(map(torch.from_numpy, carry))
    j_carry = carry
    for p in range(P):
        t_carry, t_regs = tref.engine_hop_ref(
            torch.from_numpy(win)[:, p], t_carry, dev, p, S)
        j_carry, j_regs = _jax_hop(win[:, p], j_carry, tables, p, S)
        _assert_hop_equal(t_carry, t_regs, j_carry, j_regs, f"hop {p}")
    # the walk moved: some flows exited, some recirculated, done ones held
    assert (j_carry[1] & ~carry[1]).any()
    assert (j_carry[3] > carry[3]).any()


# ---------------------------------------------------------------------------
# a scalar mirror of the kernel's per-lane arithmetic
# ---------------------------------------------------------------------------
def _pred_bits(pk) -> int:
    """``pred_bits(pk)`` (csrc/window.cuh): bit ``pred`` set where the
    packet matches predicate code ``pred``."""
    if not pk[F.PKT_VALID] > 0:
        return 0
    flags = int(pk[F.PKT_FLAGS])                     # C truncation
    return ((1 << F.PRED_TRUE) | (pk[F.PKT_DIR] == 0) << F.PRED_FWD
            | (pk[F.PKT_DIR] == 1) << F.PRED_BWD
            | (flags & 63) << F.PRED_SYN)


def _walk_slot(window, op, field, pred, init, start=_F32(-0.0)):
    """One lane of ``walk_windows``: the lane's predicate bit against each
    packet's decoded bits, ``WindowStats`` over the window in order, f32
    scalar math, then ``reg(op, init)``."""
    pbit = 1 << pred if 0 <= pred <= F.PRED_URG else 0
    count = total = sumsq = _F32(start)
    mx, mn = _F32(-np.inf), _F32(np.inf)
    first = last = _F32(0.0)
    seen = False
    for pk in window:
        m = (_pred_bits(pk) & pbit) != 0
        v = pk[field] if 0 <= field < F.PKT_NFIELDS else _F32(0.0)
        mf = _F32(1.0 if m else 0.0)
        count = _F32(count + mf)
        total = _F32(total + _F32(v * mf))
        sumsq = _F32(sumsq + _F32(_F32(v * v) * mf))
        if m:
            if v > mx or v != v:
                mx = mx if mx != mx else v
            if v < mn or v != v:
                mn = mn if mn != mn else v
            if not seen:
                first = v
            last = v
            seen = True
    return {F.OP_COUNT: count, F.OP_SUM: total,
            F.OP_MAX: mx if np.isfinite(mx) else _F32(0.0),
            F.OP_MIN: mn if np.isfinite(mn) else init,
            F.OP_LAST: last if seen else _F32(0.0),
            F.OP_FIRST: first if seen else _F32(0.0),
            F.OP_SUMSQ: sumsq}.get(int(op), _F32(0.0))


def _mirror_hop(pkts, carry, tables, p: int, S: int, start=_F32(-0.0)):
    """``engine_hop_kernel`` flow by flow: the SID's table row (-1 wraps,
    then clamped), each slot's lane, the marks, the first hit leaf and
    the carry update.  Returns the new carry and the registers."""
    op, field, pred, init, thr, lo, hi, action, valid = tables
    sid, done, labels, recircs, exit_p = (a.copy() for a in carry)
    B, k = pkts.shape[0], op.shape[1]
    regs = np.zeros((B, k), np.float32)
    with np.errstate(all="ignore"):          # inf * 0 is NaN, as on the card
        for b in range(B):
            row = sid[b] + S if sid[b] < 0 else sid[b]
            row = min(max(row, 0), S - 1)
            for j in range(k):
                regs[b, j] = _walk_slot(pkts[b], op[row, j], field[row, j],
                                        pred[row, j], init[row, j], start)
            marks = [int((regs[b, j] > thr[row, j]).sum()) for j in range(k)]
            act = -1
            for leaf in range(lo.shape[1]):
                if valid[row, leaf] > 0 and all(
                        lo[row, leaf, j] <= marks[j] <= hi[row, leaf, j]
                        for j in range(k)):
                    act = int(action[row, leaf])
                    break
            if done[b]:
                continue
            if act >= S:
                labels[b], exit_p[b], done[b] = act - S, p, True
            else:
                recircs[b] += 1
                sid[b] = act
    return (sid, done, labels, recircs, exit_p), regs


@pytest.mark.parametrize("B,W,k", [(37, 1, 4), (45, 65, 4), (21, 9, 9),
                                   (7, 64, 41)])
def test_kernel_mirror_matches_jax(B, W, k):
    """The kernel's lanes, walked one flow at a time on f32 scalars, equal
    JAX ``fused_step`` + ``_hop_update`` over two hops on windows that
    hold -0.0 (fields, masked negative values) and order-sensitive sums."""
    rng = np.random.default_rng(7 * B + W + k)
    S, T, L = 6, 5, 6
    tables = _tables(rng, S, k, T, L)
    carry = _carry(rng, B, S)
    for p in range(2):
        pk = _packets(rng, B, W)
        want = _jax_hop(pk, carry, tables, p, S)
        got = _mirror_hop(pk, carry, tables, p, S)
        _assert_hop_equal(*got, *want, f"hop {p}")
        carry = want[0]


def test_mirror_fails_when_the_chain_starts_at_zero():
    """-0.0 is the chains' identity; +0.0 is not: a window of masked
    negative values sums to -0.0 in ``ordered_wsum`` and in the mirror,
    and to +0.0 from a +0.0 start, which the JAX comparison catches."""
    S, k, T, L, B, W = 1, 3, 2, 1, 4, 5
    tables = (np.asarray([[F.OP_SUM, F.OP_SUMSQ, F.OP_SUM]], np.int32),
              np.asarray([[F.PKT_SIZE, F.PKT_SIZE, F.PKT_IAT]], np.int32),
              np.asarray([[F.PRED_BWD, F.PRED_BWD, F.PRED_TRUE]], np.int32),
              np.zeros((S, k), np.float32),
              np.full((S, k, T), np.inf, np.float32),
              np.zeros((S, L, k), np.int32), np.full((S, L, k), T, np.int32),
              np.asarray([[S]], np.int32), np.ones((S, L), np.int32))
    pk = np.zeros((B, W, F.PKT_NFIELDS), np.float32)
    pk[..., F.PKT_SIZE] = -3.0                # masked out: -3 * 0 = -0.0
    pk[..., F.PKT_IAT] = -0.0
    pk[..., F.PKT_VALID] = 1.0                # direction 0: not PRED_BWD
    carry = _carry(np.random.default_rng(0), B, S)
    carry[0][:] = 0
    want = _jax_hop(pk, carry, tables, 0, S)
    assert np.signbit(want[1][:, 0]).all() and np.signbit(want[1][:, 2]).all()
    _assert_hop_equal(*_mirror_hop(pk, carry, tables, 0, S), *want, "-0.0")
    _, regs = _mirror_hop(pk, carry, tables, 0, S, start=_F32(0.0))
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(regs.view(np.int32),
                                      want[1].view(np.int32))


def test_subnormal_fields_keep_ieee_values():
    """On subnormal fields the kernel's lanes keep IEEE values (the
    kernels are built without -ftz), as the port's plain version does
    and as the numpy oracle does
    (:func:`test_subnormal_fields_equal_the_numpy_oracle`); XLA on the
    CPU flushes them to zero, so there the JAX engine's registers leave
    the oracle (ROADMAP C, seen on the reference side).  The mirror
    equals the port's plain version on every op, and JAX wherever a
    flush changes nothing."""
    rng = np.random.default_rng(11)
    B, W, k, S = 16, 12, F.N_OPS, 1
    pk = _packets(rng, B, W, values=_SUBNORMAL)
    pk[..., F.PKT_VALID] = 1.0
    op = np.arange(F.N_OPS, dtype=np.int32)[None]
    field = np.full((1, k), F.PKT_SIZE, np.int32)
    pred = np.zeros((1, k), np.int32)
    init = np.zeros((1, k), np.float32)
    mirror = np.asarray([[_walk_slot(pk[b], op[0, j], F.PKT_SIZE, 0,
                                     init[0, j]) for j in range(k)]
                         for b in range(B)])
    rows = tuple(np.repeat(a, B, axis=0) for a in (op, field, pred, init))
    port = tref.feature_window_ref(torch.from_numpy(pk),
                                   *map(torch.from_numpy, rows)).numpy()
    np.testing.assert_array_equal(mirror.view(np.int32), port.view(np.int32))
    j = np.asarray(jref.feature_window_ref(jnp.asarray(pk),
                                           *map(jnp.asarray, rows)))
    flush_free = [F.OP_NONE, F.OP_COUNT, F.OP_LAST, F.OP_FIRST, F.OP_SUMSQ]
    np.testing.assert_array_equal(mirror[:, flush_free].view(np.int32),
                                  j[:, flush_free].view(np.int32))
    # every field is subnormal or -0.0: XLA flushed every term of every
    # SUM, the kernel's lanes kept them
    assert mirror[:, F.OP_SUM].any() and not j[:, F.OP_SUM].any()


def _registry_rows(B: int):
    """Every registry feature as a slot: (B, N_FEATURES) op, field, pred
    and init rows."""
    spec = lambda a, dt: np.tile(np.asarray(
        [getattr(f, a) for f in F.REGISTRY], dt)[None], (B, 1))
    return (spec("op", np.int32), spec("field", np.int32),
            spec("pred", np.int32), spec("init_value", np.float32))


# every partial sum of a window of these stays a multiple of 2^-149 below
# 2^-125, so every f32 addition is exact: the f32 chain and the oracle's
# f64 sum rounded once agree, and any difference would be a flush
_SMALL_SUBNORMAL = np.asarray([1e-40, -2e-40, 3e-41, -1e-45, 1.4e-39,
                               -0.0], np.float32)


@pytest.mark.parametrize("values", [_SMALL_SUBNORMAL, _SUBNORMAL])
def test_subnormal_fields_equal_the_numpy_oracle(values):
    """ROADMAP C.2 is not a fault of the port: on windows of subnormal
    fields the port's plain version equals the numpy oracle
    ``compute_feature`` -- the port's copy and the JAX package's, which
    agree bit for bit -- for every registry feature.  With the larger
    subnormals (up to 1.17e-38) a window's sum leaves the exact range and
    the f32 chain rounds where the oracle's f64 sum does not, as it does
    on normal values (``tests/test_features.py`` holds the chain to the
    oracle at a tolerance there), so the SUM features are left out of the
    bit comparison for that set only; every other op is compared."""
    from repro.core import features as JF
    rng = np.random.default_rng(13)
    B, W = 64, 12
    pk = _packets(rng, B, W, values=values)
    assert np.isin(pk[..., [F.PKT_TS, F.PKT_SIZE, F.PKT_IAT]],
                   values).all()
    rows = _registry_rows(B)
    port = tref.feature_window_ref(torch.from_numpy(pk),
                                   *map(torch.from_numpy, rows)).numpy()
    exact = values is _SMALL_SUBNORMAL
    compared = 0
    for spec in F.REGISTRY:
        oracle = F.compute_feature(pk, spec)
        np.testing.assert_array_equal(
            oracle.view(np.int32),
            JF.compute_feature(pk, JF.REGISTRY[spec.fid]).view(np.int32),
            err_msg=spec.name)
        if spec.op == F.OP_SUM and not exact:
            continue
        np.testing.assert_array_equal(port[:, spec.fid].view(np.int32),
                                      oracle.view(np.int32),
                                      err_msg=spec.name)
        compared += 1
    # the subnormals reach the registers: nonzero sums below FLT_MIN
    sums = [f.fid for f in F.REGISTRY if f.op == F.OP_SUM]
    tiny = np.abs(port[:, sums])
    assert ((tiny > 0) & (tiny < np.finfo(np.float32).tiny)).any()
    assert compared == F.N_FEATURES or not exact


# ---------------------------------------------------------------------------
# launch geometry (kernels/window.py, csrc/window.cuh)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 8, 9, 41, WINDOW_THREADS])
@pytest.mark.parametrize("W", [1, 64, 65])
def test_window_geometry(k, W):
    B = 1000 * k + 37                 # no multiple of the tile
    g = window_geometry(B, W, k)
    assert g.flows == WINDOW_THREADS // k and g.flows * k <= WINDOW_THREADS
    assert g.ctas == -(-B // g.flows) and (g.ctas - 1) * g.flows < B
    assert 1 <= g.chunk <= W and g.n_chunks == -(-W // g.chunk)
    # a staged chunk of the tile holds about STAGE_BYTES, at most all of W
    chunk_bytes = g.flows * g.chunk * F.PKT_NFIELDS * 4
    assert chunk_bytes <= STAGE_BYTES
    assert g.chunk == W or chunk_bytes + g.flows * 24 > STAGE_BYTES
    # a staged flow fits its chunk in an odd number of 8-byte words: 16
    # neighbouring flows start in 16 distinct bank pairs
    assert g.stride >= F.PKT_NFIELDS * g.chunk and g.stride % 2 == 0
    assert (g.stride // 2) % 2 == 1
    assert len({(f * g.stride // 2) % 16 for f in range(16)}) == 16
    row = g.chunk | 1                 # a flow's predicate words, odd
    assert row >= g.chunk and len({f * row % 32 for f in range(32)}) == 32
    buffers = min(g.n_chunks, STAGES)
    assert g.smem_bytes == 4 * (buffers * g.flows * g.stride + g.flows * row
                                + g.flows * k)
    assert g.smem_bytes <= 227 * 1024
    # the carveout fits ctas_per_sm CTAs, and L1 keeps twice their chunks
    in_flight = g.ctas_per_sm * g.flows * g.chunk * 24
    smem = g.ctas_per_sm * (g.smem_bytes + 1024)
    assert 1 <= g.ctas_per_sm <= 8 and 1 <= g.carveout <= 100
    assert smem <= g.carveout / 100 * 228 * 1024 < smem + 228 * 1024 / 100
    assert smem + 2 * in_flight <= 256 * 1024 or g.ctas_per_sm == 1


def test_window_geometry_alignment_at_w65():
    """The engine's hop view of a (B, 3, 65, 6) tensor: flows 4,680 bytes
    apart, so every other flow's window starts at 8 mod 16, and each chunk
    of it too: the 8-byte copies need no unaligned head or tail.  At W = 64
    all start 16-byte aligned.  The carveout fits four CTAs of the k = 4
    launch, 1 KB a CTA reserved."""
    stride65 = 3 * 65 * F.PKT_NFIELDS
    assert 4 * stride65 == 4680
    assert [(b * 4 * stride65) % 16 for b in range(4)] == [0, 8, 0, 8]
    g = window_geometry(1 << 20, 65, 4)
    assert (g.flows, g.chunk, g.stride, g.n_chunks) == (64, 8, 50, 9)
    assert g.ctas == 16384 and g.smem_bytes == 28928
    # four CTAs, 49 KB of copies in flight, ~124 KB of L1 left
    assert (g.ctas_per_sm, g.carveout) == (4, 52)
    # at W = 64 every window of the view starts 16-byte aligned
    assert all((b * 3 + p) * 64 * 24 % 16 == 0
               for b in range(4) for p in range(3))
    # every chunk of every flow: whole 8-byte words from an 8-byte
    # aligned start, and some of them at 8 mod 16
    phases = set()
    for b in range(4):
        for c in range(g.n_chunks):
            s0 = b * 4 * stride65 + c * g.chunk * 24
            nbytes = min(g.chunk, 65 - c * g.chunk) * 24
            assert s0 % 8 == 0 and nbytes % 8 == 0
            phases.add(s0 % 16)
    assert phases == {0, 8}
    for bad in (0, WINDOW_THREADS + 1):
        with pytest.raises(ValueError, match="k in 1"):
            window_geometry(8, 65, bad)


# ---------------------------------------------------------------------------
# the walk's fetch
# ---------------------------------------------------------------------------
def _small_engine(k: int = 3):
    from repro_torch.core.partition import train_partitioned_dt
    from repro_torch.flows.synthetic import make_dataset
    from repro_torch.flows.windows import window_features, window_packets
    ds = make_dataset("d2", 200, seed=5)
    X = window_features(ds, 3, device="cpu")
    pdt = train_partitioned_dt(X, ds.labels, partition_sizes=[2, 2, 2], k=k)
    return inf.Engine.from_model(pdt, device="cpu"), window_packets(ds, 3)


def test_walk_buffer_is_the_fetch_layout():
    """labels | recircs | exit_partition | the bit-cast (P, B, k) trace
    | the per-hop survivor counts, each hop writing its verdicts and
    registers in place."""
    eng, wp = _small_engine()
    x = torch.from_numpy(wp)
    B, P = x.shape[0], eng.tables.n_partitions
    k = eng.tables.dev.slot_op.shape[1]
    buf = inf.partition_walk(x, eng.tables.dev,
                             n_subtrees=eng.tables.n_subtrees,
                             n_partitions=P, with_trace=True)
    assert buf.dtype == torch.int32 and buf.shape == (3 * B + P * B * k,)
    res = eng.run(wp)
    host = buf.numpy()
    for i, name in enumerate(("labels", "recircs", "exit_partition")):
        np.testing.assert_array_equal(host[i * B:(i + 1) * B],
                                      getattr(res, name))
    trace = host[3 * B:].view(np.float32).reshape(P, B, k)
    for p in range(P):
        np.testing.assert_array_equal(trace[p], res.regs_trace[p])
    short = inf.partition_walk(x, eng.tables.dev,
                               n_subtrees=eng.tables.n_subtrees,
                               n_partitions=P)
    assert torch.equal(short, buf[:3 * B])
    # count_survivors appends the flows still walking as each hop starts
    counted = inf.partition_walk(x, eng.tables.dev,
                                 n_subtrees=eng.tables.n_subtrees,
                                 n_partitions=P, with_trace=True,
                                 count_survivors=True)
    assert counted.shape == (3 * B + P * B * k + P,)
    assert torch.equal(counted[:-P], buf)
    e = res.exit_partition
    assert counted[-P:].tolist() == [
        int(np.count_nonzero((e < 0) | (e >= p))) for p in range(P)]
    assert counted[-P:][0] == B


def test_plain_hop_counts_its_done_flows():
    """The plain hop's ``survivors_out`` loses the flows done after a
    dense hop, which ``partition_walk(count_survivors=True)`` reads for
    the survivor counts; a compacted hop refuses it."""
    eng, wp = _small_engine()
    x = torch.from_numpy(wp)
    B, P = x.shape[0], eng.tables.n_partitions
    _, carry, _ = inf._walk_buffers(B, P, eng.tables.dev.slot_op.shape[1],
                                    False, x.device)
    left = torch.full((P,), B, dtype=torch.int32)
    done = []
    for p in range(P):
        engine_hop_plain(x[:, p], carry, eng.tables.dev, p,
                         n_subtrees=eng.tables.n_subtrees,
                         survivors_out=left[p])
        done.append(int(carry[1].sum()))
    assert done == sorted(done) and 0 < done[-1] <= B
    assert left.tolist() == [B - d for d in done]
    with pytest.raises(ValueError, match="dense hop only"):
        engine_hop_plain(x[:, 1], carry, eng.tables.dev, 1,
                         n_subtrees=eng.tables.n_subtrees,
                         rows=torch.arange(B, dtype=torch.int32),
                         n_active=torch.tensor([B], dtype=torch.int32),
                         survivors_out=left[0])


def test_results_own_their_arrays():
    """Two consecutive runs: the first result's arrays stay as they were
    and share no memory with the second's."""
    eng, wp = _small_engine()
    first = eng.run(wp)
    kept = {n: getattr(first, n).copy()
            for n in ("labels", "recircs", "exit_partition")}
    kept_trace = [r.copy() for r in first.regs_trace]
    second = eng.run(np.ascontiguousarray(wp[::-1]))
    assert not np.array_equal(second.labels, first.labels)
    for n, a in kept.items():
        np.testing.assert_array_equal(getattr(first, n), a)
        assert not np.shares_memory(getattr(first, n), getattr(second, n))
    for a, b in zip(first.regs_trace, kept_trace):
        np.testing.assert_array_equal(a, b)


def test_two_kernel_walk_adapter_equals_the_plain_hop():
    """``step_hop(fused_step)``, the adapter the two-kernel walk rides on
    and ``engine_hop_plain`` is, writes what ``engine_hop_ref`` returns."""
    eng, wp = _small_engine()
    x = torch.from_numpy(wp)
    kw = dict(n_subtrees=eng.tables.n_subtrees,
              n_partitions=eng.tables.n_partitions, with_trace=True)

    def ref_hop(pkts, carry, dev, p, *, n_subtrees, regs_out=None):
        new, regs = tref.engine_hop_ref(pkts, carry, dev, p, n_subtrees)
        for dst, src in zip(carry, new):
            dst.copy_(src)
        regs_out.copy_(regs)

    a = inf.partition_walk(x, eng.tables.dev, hop=ref_hop, **kw)
    b = inf.partition_walk(x, eng.tables.dev,
                           hop=step_hop(tref.fused_step), **kw)
    assert torch.equal(a, b)
    assert torch.equal(
        a, inf.partition_walk(x, eng.tables.dev, hop=engine_hop_plain, **kw))
