"""Kernel B's per-flow form and the fold's table form: their plain
versions against the JAX package at zero tolerance, and the kernels
against those plain versions on the card.

Kernel B (``csrc/dt_traverse.cu``) matches each flow against its own
subtree with no SID dispatch; its per-flow plain version
(``dt_traverse_flows_ref``, the dense gather of each row's subtree) must
equal JAX's ``dispatch_dt_traverse`` on the same flows, SIDs of -1
reading row S - 1.  The fold's table form (``csrc/feature_update.cu``)
folds the resident state in place; its plain version must equal JAX's
``feature_update_at`` (gather, Pallas kernel in interpret mode,
scatter), dummy-row padding included, and a mirror of the in-place
kernel (each entry reads the table as the entries before it left it)
must equal both bit for bit.  JAX is imported in a fixture, so the
``gpu`` tests run where it is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import features as F
from repro_torch.kernels import dispatch
from repro_torch.kernels import dt_traverse as dtt
from repro_torch.kernels import feature_window as fw
from repro_torch.kernels import ref

# order-sensitive values; every square stays finite (the Pallas kernel
# in interpret mode gives 0.0 for an overflowing square masked out)
_VALUES = np.asarray([1.0, 1e8, -1e8, 3.25, -0.0, 1500.0, 40.0, 7e-4,
                      16777216.0, 1.0e-30], np.float32)
_NAN = np.float32(np.nan)


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import dispatch as j_dispatch
    from repro.kernels import feature_window as j_fw
    return jnp, j_dispatch, j_fw


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _bits(x) -> np.ndarray:
    """Float arrays as their int32 bit patterns, the sign of a zero
    included, every NaN as one pattern (a NaN's payload and sign are not
    the fold's: vector and scalar code, on either side, set them
    differently); int arrays as they are."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if x.dtype != np.float32:
        return x
    return np.where(np.isnan(x), np.int32(0x7FC00000), x.view(np.int32))


def _same(a: torch.Tensor, b: torch.Tensor, bits: bool = False) -> bool:
    """``torch.equal`` with NaN equal to NaN; with ``bits`` the sign of a
    zero counts too.  The card's plain version departs from the kernels
    on the sign of a zero under MAX and MIN (``torch.maximum`` there
    keeps -0.0 against +0.0; docs/PARITY.md §5 allows it), so the
    kernels are held to it by value and to each other by bits."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    eq = (a.view(torch.int32) == b.view(torch.int32)) if bits else (a == b)
    return bool((eq | (torch.isnan(a) & torch.isnan(b))).all())


# ---------------------------------------------------------------------------
# kernel B, per-flow form
# ---------------------------------------------------------------------------
def _range_case(seed: int, B: int, S: int, k: int, T: int, L: int,
                ascending: bool = True):
    """Tables with +inf padding, overlapping leaf boxes, bounds below 0
    and above T, invalid leaves, a subtree with none, a -1 action;
    registers on the thresholds; SIDs over [-1, S).  ``ascending``
    False shuffles each threshold row."""
    rng = np.random.default_rng(seed)
    thr = np.sort(rng.choice(_VALUES, (S, k, T)), axis=2).astype(np.float32)
    thr[:, :, T - 2:] = np.inf
    if not ascending:
        thr = np.ascontiguousarray(np.take_along_axis(thr, rng.permuted(
            np.broadcast_to(np.arange(T), thr.shape), axis=2), axis=2))
    lo = rng.integers(-1, T // 2, (S, L, k)).astype(np.int32)
    hi = (lo + rng.integers(0, T + 2, (S, L, k))).astype(np.int32)
    act = rng.integers(0, 3 * S, (S, L)).astype(np.int32)
    act[:, L - 1] = -1
    valid = (rng.random((S, L)) < 0.8).astype(np.int32)
    valid[0] = 0
    regs = rng.choice(_VALUES, (B, k)).astype(np.float32)
    on = rng.random((B, k)) < 0.3
    regs[on] = thr[rng.integers(0, S), 0, 0]
    regs[::7, 0] = _NAN
    sid = rng.integers(-1, S, B).astype(np.int32)
    sid[:3] = -1
    return regs, sid, (thr, lo, hi, act, valid)


@pytest.mark.parametrize("B,S,k,T,L", [(90, 7, 5, 8, 20), (41, 3, 3, 6, 16)])
def test_per_flow_plain_route_matches_jax_dispatch(jx, B, S, k, T, L):
    """``dt_traverse_flows_ref`` (the CPU side of ``ops.dt_traverse_dev``
    and the plain route the card's one launch mirrors) == JAX's
    ``dispatch_dt_traverse`` (Pallas interpret) on the wrapped SIDs, and
    the port's CPU ``dispatch_dt_traverse`` too."""
    jnp, j_dispatch, _ = jx
    regs, sid, tables = _range_case(B + S + k, B, S, k, T, L)
    wrapped = np.where(sid < 0, sid + S, sid).astype(np.int32)
    want = np.asarray(j_dispatch.dispatch_dt_traverse(
        *map(jnp.asarray, (regs, wrapped, *tables)), interpret=True,
        block_b=8))
    got = dtt.dt_traverse_flows_ref(*_torch(regs, sid, *tables))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dispatch.dispatch_dt_traverse(
        *_torch(regs, wrapped, *tables), block_b=8).numpy(), want)
    assert (want == -1).any() and (want >= 0).any()


def _staged_mirror(regs, sid, thr, lo, hi, act, valid, lowest=True):
    """The staged path of ``csrc/dt_traverse.cu`` in numpy: a leaf mask
    for every (subtree, slot, mark) from each leaf's [lo, hi] clipped to
    [0, T], the valid mask, marks by binary search where every threshold
    row ascends (the linear count otherwise), then the lowest set bit of
    valid & AND_j mask (``lowest`` False takes the highest: a mutation
    the test must catch)."""
    S, k, T = thr.shape
    L = lo.shape[1]
    mask = np.zeros((S, k, T + 1), np.uint64)
    for row in range(S):
        for l in range(L):
            for j in range(k):
                a_, b_ = max(lo[row, l, j], 0), min(hi[row, l, j], T)
                mask[row, j, a_:b_ + 1] |= np.uint64(1 << l)
    vmask = ((valid > 0).astype(np.uint64)
             << np.arange(L, dtype=np.uint64)).sum(axis=1)
    ascends = bool((thr[:, :, :-1] <= thr[:, :, 1:]).all())
    rows = np.where(sid < 0, sid + S, sid)
    out = np.empty(regs.shape[0], np.int32)
    for b, row in enumerate(rows):
        hit = vmask[row]
        for j in range(k):
            v, th = regs[b, j], thr[row, j]
            if ascends:
                m = next((t for t in range(T) if not v > th[t]), T)
            else:
                m = int((v > th).sum())
            hit &= mask[row, j, m]
        if hit == 0:
            out[b] = -1
        else:
            bits = [l for l in range(L) if int(hit) >> l & 1]
            out[b] = act[row, bits[0] if lowest else bits[-1]]
    return out


@pytest.mark.parametrize("ascending", [True, False])
def test_staged_mirror_matches_the_plain_route(ascending):
    """The staged path's mask match (scalar mirror) == the per-flow plain
    route, which the test above holds to JAX; taking the highest hit
    instead of the lowest fails."""
    regs, sid, tables = _range_case(5 + ascending, 300, 6, 4, 8, 20,
                                    ascending=ascending)
    want = dtt.dt_traverse_flows_ref(*_torch(regs, sid, *tables)).numpy()
    np.testing.assert_array_equal(_staged_mirror(regs, sid, *tables), want)
    assert not np.array_equal(
        _staged_mirror(regs, sid, *tables, lowest=False), want)
    assert dtt.kernel_path(6, 4, 8, 20) == "staged"


def test_kernel_paths():
    assert dtt.kernel_path(30, 4, 8, 8) == "staged"       # the engine's
    assert dtt.kernel_path(4, 41, 8, 16) == "staged"
    assert dtt.kernel_path(600, 4, 8, 8) == "serial"      # past 48 KB
    assert dtt.kernel_path(7, 5, 6, 40) == "warp"         # L > 32
    assert dtt.kernel_path(1282, 4, 16, 64) == "warp"     # the fleet's


def test_block_plain_route_is_the_per_flow_one_by_block():
    regs, _, tables = _range_case(3, 48, 5, 4, 8, 8)
    block_sid = np.asarray([4, 0, 2], np.int32)
    got = dtt.dt_traverse_blocks_ref(*_torch(block_sid, regs, *tables),
                                     block_b=16)
    want = dtt.dt_traverse_flows_ref(
        *_torch(regs, np.repeat(block_sid, 16), *tables))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the fold, table form
# ---------------------------------------------------------------------------
_OPS = np.asarray([F.OP_COUNT, F.OP_SUM, F.OP_SUMSQ, F.OP_MAX, F.OP_MIN,
                   F.OP_FIRST, F.OP_LAST], np.int32)


def _fold_case(seed: int, N: int, n: int, n_real: int, S: int, k: int):
    """A resident (N + 1, k) state whose dummy row N holds -0.0 and NaN,
    SID-keyed (S, k) slot tables over every op, and a rank of ``n``
    entries: ``n_real`` unique real rows, then duplicates of the dummy
    row with a zero packet and SID 0, as ``FlowTableServer._pad_slots``
    pads them."""
    rng = np.random.default_rng(seed)
    op = rng.choice(_OPS, (S, k)).astype(np.int32)
    op.flat[:_OPS.size] = _OPS
    field = rng.integers(-1, F.PKT_NFIELDS + 1, (S, k)).astype(np.int32)
    pred = rng.integers(0, F.N_PREDS, (S, k)).astype(np.int32)
    init = rng.normal(size=(S, k)).astype(np.float32)
    acc = rng.choice(_VALUES, (N + 1, k)).astype(np.float32)
    acc[rng.random((N + 1, k)) < 0.1] = _NAN
    acc[N] = np.resize(np.asarray([-0.0, _NAN], np.float32), k)
    seen = rng.integers(0, 2, (N + 1, k)).astype(np.int32)
    slots = np.full(n, N, np.int32)
    slots[:n_real] = rng.permutation(N)[:n_real]
    sid = np.zeros(n, np.int32)
    sid[:n_real] = rng.integers(-1, S, n_real)
    pkt = np.zeros((n, F.PKT_NFIELDS), np.float32)
    pkt[:n_real, F.PKT_SIZE] = rng.choice(_VALUES, n_real)
    pkt[:n_real, F.PKT_IAT] = rng.choice(_VALUES, n_real)
    pkt[:n_real, F.PKT_DIR] = rng.integers(0, 2, n_real)
    pkt[:n_real, F.PKT_FLAGS] = rng.integers(0, 64, n_real)
    pkt[:n_real, F.PKT_VALID] = rng.random(n_real) < 0.8
    return acc, seen, slots, sid, pkt, (op, field, pred, init)


def _in_place_mirror(acc, seen, slots, sid, pkt, tables, finalize=False):
    """The table-form kernel's result when its entries run one after
    another, each reading the table as the earlier ones left it: the
    order in which a duplicate reads another's write."""
    acc, seen = acc.clone(), seen.clone()
    s = sid.to(torch.int64)
    rows = [t[s] for t in tables]
    regs = []
    for r in range(slots.shape[0]):
        i = int(slots[r])
        one = [t[r:r + 1] for t in rows]
        if finalize:
            a2, s2, reg = ref.feature_update_finalize_ref(
                pkt[r:r + 1], *one, acc[i:i + 1], seen[i:i + 1])
            regs.append(reg)
        else:
            a2, s2 = ref.feature_update_ref(pkt[r:r + 1], *one[:3],
                                            acc[i:i + 1], seen[i:i + 1])
        acc[i], seen[i] = a2[0], s2[0]
    return (acc, seen, torch.cat(regs)) if finalize else (acc, seen)


@pytest.mark.parametrize("k", [4, 5])
def test_table_fold_plain_route_matches_jax_feature_update_at(jx, k):
    """Both table forms' plain route (slot rows pre-gathered, as
    ``feature_update_at`` takes them; SID-keyed, as ``_fold_rank`` calls
    it) == JAX's ``feature_update_at`` (Pallas interpret), dummy-row
    duplicates holding -0.0 and NaN included; the in-place mirror equals
    it bit for bit, in either entry order."""
    jnp, _, j_fw = jx
    N, n, n_real, S = 30, 16, 10, 4
    acc, seen, slots, sid, pkt, tabs = _fold_case(k, N, n, n_real, S, k)
    r = np.where(sid < 0, sid + S, sid)
    gathered = [t[r] for t in tabs[:3]]
    want = j_fw.feature_update_at(
        *map(jnp.asarray, (acc, seen, slots, pkt, *gathered)),
        interpret=True, block_b=8)
    t_acc, t_seen, t_slots, t_sid, t_pkt = _torch(acc, seen, slots, sid, pkt)
    t_tabs = _torch(*tabs)
    at = fw.feature_update_at(t_acc.clone(), t_seen.clone(), t_slots, t_pkt,
                              *_torch(*gathered))
    keyed = fw.feature_update_table_ref(t_acc.clone(), t_seen.clone(),
                                        t_slots, t_sid, t_pkt, *t_tabs[:3])
    mirror = _in_place_mirror(t_acc, t_seen, t_slots, t_sid, t_pkt,
                              t_tabs[:3])
    mirror_rev = _in_place_mirror(t_acc, t_seen, t_slots.flip(0),
                                  t_sid.flip(0), t_pkt.flip(0), t_tabs[:3])
    for got in (at, keyed, mirror, mirror_rev):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got, at):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    # the dummy row's -0.0 under COUNT (slot 0 of SID 0) became +0.0, its
    # NaN under SUM stayed NaN: the cases the idempotence argument is about
    assert tabs[0][0, 0] == F.OP_COUNT and tabs[0][0, 1] == F.OP_SUM
    assert _bits(acc[N, :2]).tolist() == [-2**31, 0x7FC00000]
    assert _bits(at[0][N, :2]).tolist() == [0, 0x7FC00000]


def test_in_place_mirror_departs_on_a_valid_duplicate():
    """The contract has teeth: a duplicate carrying a valid packet folds
    twice in place (COUNT counts it twice), where the gather-then-scatter
    route folds it once."""
    acc, seen, slots, sid, pkt, tabs = _fold_case(1, 20, 8, 4, 3, 4)
    pkt[4:, F.PKT_VALID] = 1.0
    tabs[0][0, 0], tabs[2][0, 0] = F.OP_COUNT, F.PRED_TRUE
    t_acc, t_seen, t_slots, t_sid, t_pkt = _torch(acc, seen, slots, sid, pkt)
    t_tabs = _torch(*tabs)
    once = fw.feature_update_table_ref(t_acc.clone(), t_seen.clone(),
                                       t_slots, t_sid, t_pkt, *t_tabs[:3])
    twice = _in_place_mirror(t_acc, t_seen, t_slots, t_sid, t_pkt,
                             t_tabs[:3])
    assert not np.array_equal(_bits(once[0]), _bits(twice[0]))


def test_finalize_table_plain_route_matches_jax(jx):
    """The fold-and-finalize table form == JAX's
    ``feature_update_finalize_pallas`` on the gathered rows, scattered
    back; the in-place mirror == both, bit for bit."""
    jnp, _, j_fw = jx
    N, n, n_real, S, k = 30, 16, 11, 5, 5
    acc, seen, slots, sid, pkt, tabs = _fold_case(7, N, n, n_real, S, k)
    r = np.where(sid < 0, sid + S, sid)
    gathered = [t[r] for t in tabs]
    a2, s2, regs = j_fw.feature_update_finalize_pallas(
        *map(jnp.asarray, (pkt, *gathered, acc[slots], seen[slots])),
        interpret=True, block_b=8)
    want_acc, want_seen = acc.copy(), seen.copy()
    want_acc[slots], want_seen[slots] = np.asarray(a2), np.asarray(s2)
    t_acc, t_seen, t_slots, t_sid, t_pkt = _torch(acc, seen, slots, sid, pkt)
    got = fw.feature_update_finalize_table_ref(
        t_acc.clone(), t_seen.clone(), t_slots, t_sid, t_pkt, *_torch(*tabs))
    mirror = _in_place_mirror(t_acc, t_seen, t_slots, t_sid, t_pkt,
                              _torch(*tabs), finalize=True)
    for g, m, w in zip(got, mirror, (want_acc, want_seen, regs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(_bits(g), _bits(m))


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------
def test_wrappers_refuse_cpu_tensors_naming_the_plain_route():
    regs, sid, tables = _range_case(0, 16, 3, 4, 8, 8)
    t = _torch(regs, sid, *tables)
    with pytest.raises(ValueError, match="CUDA.*dt_traverse_flows_ref"):
        dtt.dt_traverse_flows_kernel(*t)
    with pytest.raises(ValueError, match="CUDA.*dt_traverse_blocks_ref"):
        dtt.dt_traverse_kernel(torch.zeros(2, dtype=torch.int32), t[0],
                               *t[2:], block_b=8)
    acc, seen, slots, sid, pkt, tabs = _fold_case(0, 10, 4, 2, 3, 4)
    a = _torch(acc, seen, slots, sid, pkt, *tabs)
    with pytest.raises(ValueError, match="CUDA.*feature_update_table_ref"):
        fw.feature_update_table_kernel(*a[:8])
    with pytest.raises(ValueError,
                       match="CUDA.*feature_update_finalize_table_ref"):
        fw.feature_update_finalize_table_kernel(*a)
    assert dtt.launches == 0
    assert fw.update_launches == 0 and fw.update_finalize_launches == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,k,T,L,ascending", [
    (20000, 30, 4, 8, 8, True), (20000, 30, 4, 8, 8, False),
    (4099, 7, 5, 6, 40, True), (333, 4, 41, 8, 16, True),
    (5000, 600, 4, 8, 8, True)])
def test_kernel_b_forms_equal_plain_on_card(card, B, S, k, T, L, ascending):
    """Both forms == their plain versions on each path (staged at k = 4
    and k = 41, with threshold rows ascending or not; cached with the
    warp match at L = 40 and the serial one past 48 KB; odd k, T no
    multiple of 4, SIDs of -1), and ``dispatch_dt_traverse`` is one
    launch of the per-flow form."""
    regs, sid, tables = _range_case(B, B, S, k, T, L, ascending)
    regs, sid, *tables = (x.to(card) for x in _torch(regs, sid, *tables))
    n0 = dtt.launches
    got = dtt.dt_traverse_flows_kernel(regs, sid, *tables)
    via = dispatch.dispatch_dt_traverse(regs, sid, *tables, block_b=128)
    torch.cuda.synchronize()
    assert dtt.launches == n0 + 2
    want = dtt.dt_traverse_flows_ref(regs, sid, *tables)
    assert torch.equal(got, want) and torch.equal(via, want)
    bb = 16
    nb = B // bb
    block_sid = sid[:nb].clamp(min=0)
    got_b = dtt.dt_traverse_kernel(block_sid, regs[:nb * bb], *tables,
                                   block_b=bb)
    assert torch.equal(got_b, dtt.dt_traverse_blocks_ref(
        block_sid, regs[:nb * bb], *tables, block_b=bb))


@pytest.mark.gpu
@pytest.mark.parametrize("N,n,n_real,k", [(40000, 32768, 30000, 4),
                                          (600, 333, 300, 5)])
def test_fold_table_forms_equal_plain_on_card(card, N, n, n_real, k):
    """The table forms, SID-keyed and pre-gathered, fold the state in
    place equal to their plain versions bit by bit (dummy-row duplicates
    holding -0.0 and NaN); ``feature_update_at`` is one launch."""
    acc, seen, slots, sid, pkt, tabs = _fold_case(n, N, n, n_real, 6, k)
    acc, seen, slots, sid, pkt, *tabs = (
        x.to(card) for x in _torch(acc, seen, slots, sid, pkt, *tabs))
    want = fw.feature_update_table_ref(acc.clone(), seen.clone(), slots,
                                       sid, pkt, *tabs[:3])
    n0, f0 = fw.update_launches, fw.update_finalize_launches
    got = fw.feature_update_table_kernel(acc.clone(), seen.clone(), slots,
                                         sid, pkt, *tabs[:3])
    s = sid.long()
    got_at = fw.feature_update_at(acc.clone(), seen.clone(), slots, pkt,
                                  *(t[s] for t in tabs[:3]))
    want_f = fw.feature_update_finalize_table_ref(
        acc.clone(), seen.clone(), slots, sid, pkt, *tabs)
    got_f = fw.feature_update_finalize_table_kernel(
        acc.clone(), seen.clone(), slots, sid, pkt, *tabs)
    torch.cuda.synchronize()
    assert (fw.update_launches, fw.update_finalize_launches) == (n0 + 2,
                                                                 f0 + 1)
    for g, w in zip((*got, *got_at, *got_f), (*want, *want, *want_f)):
        assert _same(g, w)
    # the dummy row, whose duplicates fold an invalid packet: bit for bit
    # (its -0.0 under COUNT became +0.0 on both sides)
    for g, w in zip(got, want):
        assert _same(g[N], w[N], bits=True)
    # the row forms from the same template, on the real rows: bit for bit
    r = slots[:n_real].long()
    rows = [t[s[:n_real]] for t in tabs]
    row_fold = fw.feature_update_kernel(pkt[:n_real], *rows[:3], acc[r],
                                        seen[r])
    row_fin = fw.feature_update_finalize_kernel(pkt[:n_real], *rows,
                                                acc[r], seen[r])
    for g, w in zip((got[0][r], got[1][r], got_f[0][r], got_f[1][r],
                     got_f[2][:n_real]), (*row_fold, *row_fin)):
        assert _same(g, w, bits=True)
