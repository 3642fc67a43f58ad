"""The hop kernel on deep subtrees and kernel A's shared slot rows.

The design-space search's models are deep (S up to 1,282 subtrees, T up
to 64 thresholds, L up to 704 leaves), so on such tables the hop kernel
(``csrc/engine_hop.cu``) matches a flow with a warp's 32 lanes together
(``fold.cuh``'s ``warp_first_hit_leaf``), and without a trace it walks no
flow that is done before the hop.  ``window_features`` launches kernel A
once a call, under one slot row that all flows share (row stride 0).

On the CPU, against the JAX package at zero tolerance:

* a scalar mirror of the warp match (rounds of 32 leaves, the lowest hit
  of the first round whose ballot is not empty) inside the mirror of the
  hop, against JAX ``fused_step`` + ``_hop_update`` over two hops on deep
  random tables: overlapping leaf boxes, invalid leaves, a hit in the
  last round only, no hit at all (action -1, then a SID of -1), NaN
  registers; the mirror made to take the last hit of a round fails;
* the done-flow skip on the mirror: the carry of a done flow is left as
  it is and the survivors word equals the plain hop's;
* kernel A's slot-row checks (``slot_row_stride``), and the plain version
  on one shared row;
* ``window_features`` on the CPU against JAX's.

On the card (marker ``gpu``): the hop kernel against ``engine_hop_plain``
on the deep tables, dense and in survivor mode, with and without a trace,
under both matches; kernel A on shared rows against ``feature_window_ref``;
``window_features`` against the CPU with one kernel-A launch.  JAX is
imported in a fixture, so on the card's machine the ``gpu`` tests run.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import features as F
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import _all_feature_rows, window_features
from repro_torch.kernels import compaction
from repro_torch.kernels import engine_hop as eh
from repro_torch.kernels import feature_window as fw
from repro_torch.kernels import ref as tref
from repro_torch.kernels.feature_window import slot_row_stride
from repro_torch.kernels.ops import DeviceTables

_F32 = np.float32
# flows and packets of the CPU hops: one shape, so JAX compiles its hop once
_B, _W = 45, 36
# the DSE's depth at a reduced width: L = 200 leaves is 7 rounds of 32,
# the last one partial
S, K, T, L = 5, 6, 64, 200
_VALUES = np.asarray([1.0, 1e8, -1e8, 3.25, -0.0, 1500.0, 40.0, 7e-4,
                      -7e-4, 16777216.0, -2.5, 0.0, 2.0, 5.0, 64.0],
                     np.float32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's hop and the scalar lane mirror of
    ``tests/test_torch_hop.py`` (imported here, so that the ``gpu`` tests
    run where JAX is not installed)."""
    pytest.importorskip("jax.numpy")
    import test_torch_hop as hop
    from repro.flows.synthetic import make_dataset as j_make_dataset
    from repro.flows.windows import window_features as j_window_features
    return types.SimpleNamespace(hop=hop, make_dataset=j_make_dataset,
                                 window_features=j_window_features)


def _packets(rng, B: int, W: int):
    """Windows over order-sensitive values, every predicate, empty
    windows, and NaN fields in a few flows (NaN registers mark 0)."""
    pk = np.zeros((B, W, F.PKT_NFIELDS), np.float32)
    for fld in (F.PKT_TS, F.PKT_SIZE, F.PKT_IAT):
        pk[..., fld] = rng.choice(_VALUES, (B, W))
    pk[..., F.PKT_DIR] = rng.integers(0, 2, (B, W))
    pk[..., F.PKT_FLAGS] = rng.integers(0, 64, (B, W))
    pk[..., F.PKT_VALID] = rng.random((B, W)) < 0.8
    pk[::7, :, F.PKT_VALID] = 0.0                     # empty windows
    pk[1::9, :, F.PKT_SIZE] = np.nan
    pk[2::9, -1, F.PKT_IAT] = np.nan
    return pk


def _deep_tables(rng, k: int = K, t: int = T, n_classes: int = 4):
    """Random deep subtree tables (S, k, t, L).  Rows 0 and 4: about half
    the leaves valid, most slots wildcards, so a round holds several hits
    with different actions (overlapping boxes).  Row 1: only the last
    leaf, in the last (partial) round, can hit.  Row 2: no leaf can hit
    (the action is -1, and the next hop's SID -1 reads row S - 1).  Row
    3: sparse hits spread over the rounds.  Thresholds are not sorted:
    the marks count every threshold below a register."""
    op = rng.integers(0, F.N_OPS, (S, k)).astype(np.int32)
    op.flat[:F.N_OPS] = np.arange(F.N_OPS)
    field = rng.integers(-1, F.PKT_NFIELDS + 1, (S, k)).astype(np.int32)
    pred = rng.integers(0, F.N_PREDS + 1, (S, k)).astype(np.int32)
    # the last slot sums the size under PRED_TRUE: NaN in a NaN flow
    op[:, -1], field[:, -1], pred[:, -1] = F.OP_SUM, F.PKT_SIZE, F.PRED_TRUE
    init = rng.normal(size=(S, k)).astype(np.float32)
    thr = rng.choice(_VALUES, (S, k, t)).astype(np.float32)
    thr[:, :, t - 5:] = np.inf
    full = rng.random((S, L, k)) < 0.8
    lo = np.where(full, 0, rng.integers(0, 6, (S, L, k))).astype(np.int32)
    hi = np.where(full, t, lo + rng.integers(0, t // 2, (S, L, k))
                  ).astype(np.int32)
    action = rng.integers(0, S + n_classes, (S, L)).astype(np.int32)
    valid = (rng.random((S, L)) < 0.5).astype(np.int32)
    lo[1], hi[1], valid[1] = t + 1, t, 0              # row 1: no leaf ...
    lo[1, L - 1], hi[1, L - 1], valid[1, L - 1] = 0, t, 1  # ... but the last
    lo[2, :, 0] = t + 1                               # row 2: none at all
    valid[3] = rng.random(L) < 0.08                   # row 3: sparse
    lo[3, :, :2] = rng.integers(0, 8, (L, 2))
    hi[3, :, :2] = lo[3, :, :2] + rng.integers(0, 4, (L, 2))
    return op, field, pred, init, thr, lo, hi, action, valid


def _carry(rng, B: int):
    """SIDs over every row (row 1 and 2 among them) plus -1, some done."""
    sid = rng.integers(-1, S, B).astype(np.int32)
    sid[:S + 1] = np.arange(-1, S)
    done = rng.random(B) < 0.3
    done[:S + 1] = False
    labels = np.where(done, rng.integers(0, 4, B), -1).astype(np.int32)
    recircs = rng.integers(0, 3, B).astype(np.int32)
    exit_p = np.where(done, rng.integers(0, 2, B), -1).astype(np.int32)
    return sid, done, labels, recircs, exit_p


# ---------------------------------------------------------------------------
# the warp match and the done-flow skip, mirrored on the CPU
# ---------------------------------------------------------------------------
def _warp_match(marks, lo, hi, action, valid, pick: str = "lowest") -> int:
    """``warp_first_hit_leaf``: round r's 32 lanes test leaves 32 r ..
    32 r + 31 (a lane past L tests nothing); the first round whose ballot
    is not empty gives the action of its lowest hit (``__ffs``).
    ``pick="last"`` takes the round's highest hit instead, the fault the
    JAX comparison must catch."""
    n = lo.shape[0]
    for l0 in range(0, n, 32):
        lanes = np.arange(l0, min(l0 + 32, n))
        hit = (valid[lanes] > 0) & np.all(
            (marks >= lo[lanes]) & (marks <= hi[lanes]), axis=1)
        if hit.any():
            ballot = np.flatnonzero(hit)
            return int(action[lanes[ballot[0 if pick == "lowest" else -1]]])
    return -1


def _mirror_hop(jx, pkts, carry, tables, p: int, *, pick="lowest",
                skip_done=False):
    """The hop kernel flow by flow with the warp match: the SID's table
    row, each slot's lane (``test_torch_hop._walk_slot``), the marks, the
    match, the carry update.  With ``skip_done`` (no trace) a flow done
    before the hop is not walked: its register row stays NaN here.
    Returns ``(carry, regs, survivors)``, survivors the flows not done
    after the hop."""
    op, field, pred, init, thr, lo, hi, action, valid = tables
    sid, done, labels, recircs, exit_p = (a.copy() for a in carry)
    B = pkts.shape[0]
    regs = np.full((B, K), np.nan, np.float32)
    with np.errstate(all="ignore"):           # inf * 0 is NaN, as on the card
        for b in range(B):
            if skip_done and done[b]:
                continue
            row = min(max(sid[b] + S if sid[b] < 0 else sid[b], 0), S - 1)
            for j in range(K):
                regs[b, j] = jx.hop._walk_slot(
                    pkts[b], op[row, j], field[row, j], pred[row, j],
                    init[row, j])
            marks = (regs[b][:, None] > thr[row]).sum(axis=1)
            act = _warp_match(marks, lo[row], hi[row], action[row],
                              valid[row], pick)
            if done[b]:
                continue
            if act >= S:
                labels[b], exit_p[b], done[b] = act - S, p, True
            else:
                recircs[b] += 1
                sid[b] = act
    return (sid, done, labels, recircs, exit_p), regs, int((~done).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_match_mirror_matches_jax(jx, seed):
    B, W = _B, _W
    rng = np.random.default_rng(seed)
    tables = _deep_tables(rng)
    carry = _carry(rng, B)
    seen = set()
    for p in range(2):
        pk = _packets(rng, B, W)
        want = jx.hop._jax_hop(pk, carry, tables, p, S)
        got = _mirror_hop(jx, pk, carry, tables, p)
        jx.hop._assert_hop_equal(*got[:2], *want, f"hop {p}")
        assert np.isnan(want[1]).any()                # NaN registers
        seen |= {int(s) for s in carry[0][~carry[1]]}
        carry = want[0]
    # every table row was matched, SID -1 among them, and row 2's miss
    # sent flows to SID -1 for the second hop
    assert seen >= {-1, *range(S)}
    assert (carry[0] == -1).any()


def test_last_round_and_no_hit_rows():
    """Row 1's only hit is in the last, partial round; row 2 has none."""
    rng = np.random.default_rng(5)
    _, _, _, _, _, lo, hi, action, valid = _deep_tables(rng)
    for marks in (np.zeros(K, np.int64), np.full(K, T - 5)):
        assert _warp_match(marks, lo[1], hi[1], action[1], valid[1]) \
            == action[1, L - 1]
        assert _warp_match(marks, lo[2], hi[2], action[2], valid[2]) == -1


def test_mirror_taking_the_last_hit_fails(jx):
    """The lowest hit of a round is the serial scan's first hit; the
    highest is not, and the JAX comparison catches it."""
    rng = np.random.default_rng(11)
    B, W = _B, _W
    tables = _deep_tables(rng)
    carry = _carry(rng, B)
    pk = _packets(rng, B, W)
    want = jx.hop._jax_hop(pk, carry, tables, 0, S)
    jx.hop._assert_hop_equal(*_mirror_hop(jx, pk, carry, tables, 0)[:2],
                             *want, "lowest")
    got = _mirror_hop(jx, pk, carry, tables, 0, pick="last")
    with pytest.raises(AssertionError):
        jx.hop._assert_hop_equal(*got[:2], *want, "last")


def test_done_flows_are_not_walked(jx):
    """Without a trace a done flow is not walked: its carry is left as it
    is, every carry field equals JAX's, and the survivors word equals the
    plain hop's (``survivors_out``, started at B)."""
    rng = np.random.default_rng(3)
    B, W = _B, _W
    tables = _deep_tables(rng)
    carry = _carry(rng, B)
    dev = DeviceTables(*map(torch.from_numpy, tables))
    for p in range(2):
        pk = _packets(rng, B, W)
        want = jx.hop._jax_hop(pk, carry, tables, p, S)
        got, regs, survivors = _mirror_hop(jx, pk, carry, tables, p,
                                           skip_done=True)
        done0 = carry[1]
        assert np.isnan(regs[done0]).all()             # not walked
        for g, c, w in zip(got, carry, want[0]):
            np.testing.assert_array_equal(g[done0], c[done0])
            np.testing.assert_array_equal(g, w)
        plain = tuple(torch.from_numpy(a.copy()) for a in carry)
        left = torch.full((1,), B, dtype=torch.int32)
        eh.engine_hop_plain(torch.from_numpy(pk), plain, dev, p,
                            n_subtrees=S, survivors_out=left)
        assert survivors == int(left) == B - int(want[0][1].sum())
        carry = want[0]


# ---------------------------------------------------------------------------
# kernel A's slot rows
# ---------------------------------------------------------------------------
def _rows(n: int, k: int, device="cpu"):
    rng = np.random.default_rng(n + k)
    return (torch.from_numpy(rng.integers(0, F.N_OPS, (n, k), dtype=np.int32)
                             ).to(device),
            torch.from_numpy(rng.integers(0, F.PKT_NFIELDS, (n, k),
                                          dtype=np.int32)).to(device),
            torch.from_numpy(rng.integers(0, F.N_PREDS, (n, k),
                                          dtype=np.int32)).to(device),
            torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)
                             ).to(device))


def test_slot_row_stride_checks():
    cpu = torch.device("cpu")
    assert slot_row_stride(9, _rows(9, 41), cpu) == (41, 41)
    assert slot_row_stride(9, _rows(1, 41), cpu) == (41, 0)
    assert slot_row_stride(1, _rows(1, 4), cpu) == (4, 0)
    assert slot_row_stride(0, _rows(0, 4), cpu) == (4, 4)
    for bad, match in (
            (_rows(2, 4), "need \\(B=9, k\\) or \\(1, k\\)"),
            (_rows(9, 4)[:3] + (_rows(1, 4)[3],), "slot_init"),
            ((_rows(1, 4)[0], _rows(1, 5)[1]) + _rows(1, 4)[2:],
             "need k=4 slots"),
            (_rows(1, 4)[:3] + (_rows(1, 4)[3].double(),), "slot_init"),
            ((_rows(9, 8)[0][:, ::2],) + _rows(9, 4)[1:], "slot_op"),
            ((_rows(1, 4)[0][0],) + _rows(1, 4)[1:], "need \\(B=9")):
        with pytest.raises(ValueError, match=match):
            slot_row_stride(9, bad, cpu)
    with pytest.raises(ValueError, match="on meta"):
        slot_row_stride(1, _rows(1, 4), torch.device("meta"))


def test_plain_version_takes_one_shared_row():
    """``feature_window_ref`` broadcasts a (1, k) row: every flow's
    registers equal those under the row repeated B times."""
    rng = np.random.default_rng(2)
    pk = torch.from_numpy(_packets(rng, 37, 20))
    one = _all_feature_rows(1, torch.device("cpu"))
    many = _all_feature_rows(37, torch.device("cpu"))
    got, want = tref.feature_window_ref(pk, *one), \
        tref.feature_window_ref(pk, *many)
    assert got.shape == want.shape == (37, F.N_FEATURES)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def test_window_features_on_the_cpu_equals_jax(jx):
    ds = make_dataset("d2", n_flows=300, seed=9)
    np.testing.assert_array_equal(
        window_features(ds, 6, device="cpu"),
        jx.window_features(jx.make_dataset("d2", n_flows=300, seed=9), 6))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN (its payload aside)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(card, B: int, W: int, k: int, t: int, seed: int):
    rng = np.random.default_rng(seed)
    tables = _deep_tables(rng, k, t)
    dev = DeviceTables(*(torch.from_numpy(t).to(card) for t in tables))
    carry = tuple(torch.from_numpy(a).to(card) for a in _carry(rng, B))
    pk = torch.from_numpy(_packets(rng, B, W)).to(card)
    return dev, carry, pk


@pytest.mark.gpu
@pytest.mark.parametrize("k,t", [(K, T), (4, T), (5, T - 1)])
@pytest.mark.parametrize("warp", [True, False])
@pytest.mark.parametrize("trace", [True, False])
def test_card_deep_hop_equals_plain(card, monkeypatch, warp, trace, k, t):
    """Both matches on deep tables; k = 6, 4 and 5 read the leaf bounds
    2, 4 and 1 ints at a time, T = 64 the thresholds 4 at a time and
    T = 63 one at a time."""
    monkeypatch.setattr(eh, "WARP_MATCH_MIN_LEAVES", 1 if warp else L + 1)
    B, W = 3001, 36
    dev, carry0, pk = _card_case(card, B, W, k, t,
                                 seed=int(warp) + 2 * trace + 4 * k)
    for mode in ("dense", "survivors"):
        kw = {}
        if mode == "survivors":
            rows, n_active = compaction.compact_perm(carry0[1])
            kw = dict(rows=rows, n_active=n_active)
        got = tuple(t.clone() for t in carry0)
        want = tuple(t.clone() for t in carry0)
        fill = 3.5
        regs = torch.full((B, k), fill, device=card) if trace else None
        regs_w = torch.full((B, k), fill, device=card) if trace else None
        left = (torch.full((1,), B, dtype=torch.int32, device=card)
                if mode == "dense" else None)
        left_w = None if left is None else left.clone()
        before = eh.launches
        eh.engine_hop_kernel(pk, got, dev, 1, n_subtrees=S, regs_out=regs,
                             survivors_out=left, **kw)
        assert eh.launches == before + 1
        eh.engine_hop_plain(pk, want, dev, 1, n_subtrees=S, regs_out=regs_w,
                            survivors_out=left_w, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("sid", "done", "labels", "recircs", "exit_p"),
                              got, want):
            assert torch.equal(g, w), (mode, name)
        if trace:                    # done flows keep the fill in both
            assert _same(regs, regs_w), mode
        if left is not None:
            assert torch.equal(left, left_w)


@pytest.mark.gpu
def test_card_kernel_a_shared_rows_equal_plain(card):
    rng = np.random.default_rng(4)
    pk = torch.from_numpy(_packets(rng, 4099, 65)).to(card)
    one = _all_feature_rows(1, card)
    want = tref.feature_window_ref(pk, *one)
    for rows in (one, _all_feature_rows(4099, card)):
        assert _same(fw.feature_window_kernel(pk, *rows), want)
    wide = _rows(1, 9, card)
    assert _same(fw.feature_window_kernel(pk[::2], *wide),
                 tref.feature_window_ref(pk[::2], *wide))


@pytest.mark.gpu
def test_card_window_features_one_launch(card):
    ds = make_dataset("d2", n_flows=5000, seed=3)
    want = window_features(ds, 3, device="cpu")
    fw.launches = 0
    got = window_features(ds, 3, device=card)
    assert fw.launches == 1
    np.testing.assert_array_equal(got, want)
