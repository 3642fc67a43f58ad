"""The port's kernel-level math vs the JAX package, at zero tolerance.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs its plain oracle and its Pallas kernel in interpret mode;
the port runs its plain PyTorch versions on the CPU (the CUDA kernels are
held against those same plain versions on the card, in
``test_torch_package.py`` and ``chip_smoke.py``).  Every comparison is
``assert_array_equal``: docs/PARITY.md §1 allows no ulp of difference.
"""
import numpy as np
import pytest
import torch

# the JAX package is the reference; where it is not installed (the card's
# machine) only test_torch_package.py runs
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dispatch import dispatch_dt_traverse as j_dispatch  # noqa: E402
from repro.kernels.dispatch import sid_dispatch as j_sid_dispatch  # noqa: E402
from repro.kernels.feature_window import feature_window_pallas  # noqa: E402
from repro_torch.core import features as F  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    capacity_blocks, dispatch_dt_traverse, pad_axis0, round_up, sid_dispatch,
)
from repro_torch.kernels.dt_traverse import dt_traverse_blocks_ref  # noqa: E402

# values whose f32 sums depend on the order they are added in; 3e20
# squares to inf, so (v * v) * m and v * (v * m) differ where m = 0
_SPIKY = np.asarray([1.0, 1e8, -1e8, 3.25, -0.0, 1500.0, 40.0, 7e-4,
                     16777216.0, 1.0e-30, 3.0e20], np.float32)
# the Pallas kernel in interpret mode gives 0.0, not the plain version's
# NaN, for an overflowing square masked out (ROADMAP C): it is held to the
# plain version on values whose squares stay finite
_SQ_FINITE = _SPIKY[np.abs(_SPIKY) < 1e19]


def _window_inputs(seed: int, B: int, W: int, k: int, values=_SPIKY):
    """Packets plus slot rows covering every op and predicate code,
    out-of-range field codes, all-invalid windows and order-sensitive
    values."""
    rng = np.random.default_rng(seed)
    pk = np.zeros((B, W, F.PKT_NFIELDS), np.float32)
    pk[..., F.PKT_TS] = np.cumsum(rng.exponential(0.01, (B, W)), axis=1)
    pk[..., F.PKT_SIZE] = rng.choice(values, (B, W))
    pk[..., F.PKT_DIR] = rng.integers(0, 2, (B, W))
    pk[..., F.PKT_FLAGS] = rng.integers(0, 64, (B, W))
    pk[..., F.PKT_IAT] = np.where(rng.random((B, W)) < 0.5,
                                  rng.choice(values, (B, W)),
                                  rng.exponential(0.01, (B, W)))
    pk[..., F.PKT_VALID] = rng.random((B, W)) < 0.8
    pk[::5, :, F.PKT_VALID] = 0.0                  # all-invalid windows
    op = rng.integers(0, F.N_OPS, (B, k)).astype(np.int32)
    op.flat[:F.N_OPS] = np.arange(F.N_OPS)         # every op, OP_NONE too
    field = rng.integers(-1, F.PKT_NFIELDS + 2, (B, k)).astype(np.int32)
    pred = rng.integers(0, F.N_PREDS + 1, (B, k)).astype(np.int32)
    pred.flat[:F.N_PREDS] = np.arange(F.N_PREDS)   # every predicate
    init = np.where(rng.random((B, k)) < 0.5,
                    np.finfo(np.float32).max,
                    rng.normal(size=(B, k))).astype(np.float32)
    return pk, op, field, pred, init


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("B,W,k", [(37, 1, 4), (37, 7, 41), (29, 65, 4),
                                   (11, 65, 41)])
def test_feature_window_ref_matches_jax(B, W, k):
    args = _window_inputs(B * 100 + W * 10 + k, B, W, k)
    want = np.asarray(jref.feature_window_ref(*map(jnp.asarray, args)))
    got = tref.feature_window_ref(*_torch(*args)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,W,k", [(37, 7, 4), (19, 65, 4), (13, 65, 41)])
def test_feature_window_ref_matches_pallas_interpret(B, W, k):
    args = _window_inputs(B + W + k, B, W, k, values=_SQ_FINITE)
    want = np.asarray(feature_window_pallas(
        *map(jnp.asarray, args), interpret=True, block_b=8))
    got = tref.feature_window_ref(*_torch(*args)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ordered_wsum_pins_left_to_right_order():
    """docs/PARITY.md §1: the same three numbers, two orders, two sums."""
    x = torch.tensor([[1.0, 1e8, -1e8]], dtype=torch.float32)
    assert float(tref.ordered_wsum(x)[0]) == 0.0
    assert float(tref.ordered_wsum(x.flip(1))[0]) == 1.0
    rng = np.random.default_rng(3)
    y = rng.choice(_SPIKY, (64, 65, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tref.ordered_wsum(torch.from_numpy(y)).numpy(),
        np.asarray(jref.ordered_wsum(jnp.asarray(y))))


def _range_tables(seed: int, S: int, k: int, T: int, L: int):
    rng = np.random.default_rng(seed)
    thr = np.sort(rng.choice(_SPIKY, (S, k, T)), axis=2).astype(np.float32)
    thr[:, :, T - 2:] = np.inf                     # +inf padding
    lo = rng.integers(0, T // 2, (S, L, k)).astype(np.int32)
    hi = (lo + rng.integers(0, T, (S, L, k))).astype(np.int32)
    act = rng.integers(0, 3 * S, (S, L)).astype(np.int32)
    act[:, L - 1] = -1
    valid = (rng.random((S, L)) < 0.8).astype(np.int32)
    valid[0] = 0                                   # a subtree with no leaf
    return thr, lo, hi, act, valid


def _regs(seed: int, B: int, k: int, thr: np.ndarray):
    rng = np.random.default_rng(seed)
    regs = rng.choice(_SPIKY, (B, k)).astype(np.float32)
    # registers sitting exactly on a threshold: the strict > boundary
    on = rng.random((B, k)) < 0.3
    regs[on] = thr[0, 0, 0]
    return regs


@pytest.mark.parametrize("B,S,k,T,L", [(50, 4, 4, 8, 8), (33, 7, 3, 8, 16)])
def test_dt_traverse_ref_matches_jax(B, S, k, T, L):
    thr, lo, hi, act, valid = _range_tables(B + S, S, k, T, L)
    regs = _regs(B, B, k, thr)
    sid = np.random.default_rng(S).integers(0, S, B)
    want = np.asarray(jref.dt_traverse_ref(
        jnp.asarray(regs), jnp.asarray(thr[sid]), jnp.asarray(lo[sid]),
        jnp.asarray(hi[sid]), jnp.asarray(act[sid]),
        jnp.asarray(valid[sid] > 0)))
    got = tref.dt_traverse_ref(*_torch(regs, thr[sid], lo[sid], hi[sid],
                                       act[sid], valid[sid] > 0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block_b", [8, 128])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_sid_dispatch_matches_jax(B, block_b):
    S = 6
    rng = np.random.default_rng(B * block_b)
    sid = rng.choice([0, 2, 3, 5], B).astype(np.int32)   # SIDs 1, 4 empty
    want = j_sid_dispatch(jnp.asarray(sid), n_subtrees=S, block_b=block_b)
    got = sid_dispatch(torch.from_numpy(sid), n_subtrees=S, block_b=block_b)
    for name in ("order", "dest", "block_sid"):
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.block_sid.shape[0] == capacity_blocks(B, S, block_b)


@pytest.mark.parametrize("block_b", [8, 128])
def test_dispatch_dt_traverse_matches_pallas_interpret(block_b):
    B, S, k, T, L = 70, 5, 4, 8, 8
    thr, lo, hi, act, valid = _range_tables(block_b, S, k, T, L)
    regs = _regs(block_b + 1, B, k, thr)
    sid = np.random.default_rng(block_b).integers(0, S, B).astype(np.int32)
    want = np.asarray(j_dispatch(
        *map(jnp.asarray, (regs, sid, thr, lo, hi, act, valid)),
        interpret=True, block_b=block_b))
    got = dispatch_dt_traverse(*_torch(regs, sid, thr, lo, hi, act, valid),
                               block_b=block_b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the dense plain version agrees with the dispatched one
    s = sid.astype(np.int64)
    dense = tref.dt_traverse_ref(*_torch(regs, thr[s], lo[s], hi[s], act[s],
                                         valid[s] > 0))
    np.testing.assert_array_equal(dense.numpy(), want)


def test_blocks_ref_pads_rows_without_leaking():
    """Padded capacity rows are zero registers: matched like any flow,
    never gathered back (docs/PARITY.md §3)."""
    S, k, T, L, bb = 3, 4, 8, 8, 8
    thr, lo, hi, act, valid = _range_tables(5, S, k, T, L)
    regs = _regs(6, 20, k, thr)
    sid = np.asarray([2] * 9 + [0] * 11, np.int32)
    full = dispatch_dt_traverse(*_torch(regs, sid, thr, lo, hi, act, valid),
                                block_b=bb)
    half = dispatch_dt_traverse(*_torch(regs[:9], sid[:9], thr, lo, hi, act,
                                        valid), block_b=bb)
    np.testing.assert_array_equal(full[:9].numpy(), half.numpy())
    block_sid = torch.tensor([2, 2, 0], dtype=torch.int32)
    out = dt_traverse_blocks_ref(block_sid, torch.zeros(3 * bb, k),
                                 *_torch(thr, lo, hi, act, valid), block_b=bb)
    assert out.shape == (3 * bb,) and out.dtype == torch.int32


def test_padding_helpers():
    assert round_up(37, 8) == 40 and round_up(40, 8) == 40
    x = torch.ones(3, 2)
    assert torch.equal(pad_axis0(x, 5)[3:], torch.zeros(2, 2))
    assert pad_axis0(x, 3) is x
    assert pad_axis0(np.ones((3, 2)), 4).shape == (4, 2)
    with pytest.raises(ValueError):
        pad_axis0(x, 2)


def test_per_op_entry_points_match_jax(trained_pdt, small_flow_ds):
    """``ops.feature_window`` / ``ops.dt_traverse`` on CPU tensors (the
    plain versions) equal the JAX per-op reference on real tables."""
    from repro.core.range_tables import pack_range_exec
    from repro.core.tables import pack_tables
    from repro.flows.windows import window_packets
    pdt, _, _ = trained_pdt
    tables, ret = pack_tables(pdt), pack_range_exec(pdt)
    _, te = small_flow_ds.split()
    pk = window_packets(te, 3)[:, 1]
    sid = np.random.default_rng(0).integers(
        0, ret.n_subtrees, pk.shape[0]).astype(np.int32)
    want_regs = np.asarray(jops.feature_window(
        jnp.asarray(pk), jnp.asarray(sid), tables, impl="ref"))
    regs = tops.feature_window(torch.from_numpy(pk), torch.from_numpy(sid),
                               tables)
    np.testing.assert_array_equal(regs.numpy(), want_regs)
    want_act = np.asarray(jops.dt_traverse(
        jnp.asarray(want_regs), jnp.asarray(sid), ret, impl="ref"))
    act = tops.dt_traverse(regs, torch.from_numpy(sid), ret)
    np.testing.assert_array_equal(act.numpy(), want_act)
