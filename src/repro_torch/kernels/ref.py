"""Plain PyTorch versions of the SpliDT kernels (port of the SpliDT half
of ``repro.kernels.ref``).

These are the correctness references: simple implementations with no
tiling.  The CPU path of the engine runs them, the tests hold them
against the JAX package's oracles at zero tolerance, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Bit-exactness (docs/PARITY.md §1): every windowed sum goes through
:func:`ordered_wsum`, the strict left-to-right f32 chain, and every
product is its own elementwise op (``(v * v) * m``), so nothing can be
contracted into a fused multiply-add or re-associated.
"""
from __future__ import annotations

import torch

from repro_torch.core import features as F


# ---------------------------------------------------------------------------
# feature_window: windowed stateful feature accumulation
# ---------------------------------------------------------------------------
def ordered_wsum(x: torch.Tensor) -> torch.Tensor:
    """Strict left-to-right f32 sum over the window axis (axis 1).

    The canonical reduction order shared by the offline feature pipeline
    (``window_features``), both engine steps and the CUDA feature kernel:
    ``((x0 + x1) + x2) + ...``, starting from ``x0`` (not from 0.0).
    ``torch.sum`` would pick its own summation tree, and a last-ulp
    difference can flip a flow sitting exactly on a learned threshold.
    """
    acc = x[:, 0]
    for w in range(1, x.shape[1]):
        acc = acc + x[:, w]
    return acc


def _pred_mask(pkts: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """pkts (B, W, F), pred (B, k) codes -> (B, W, k) bool."""
    valid = pkts[..., F.PKT_VALID] > 0                      # (B, W)
    direc = pkts[..., F.PKT_DIR]
    flags = pkts[..., F.PKT_FLAGS].to(torch.int32)          # truncation
    p = pred[:, None, :]                                    # (B, 1, k)
    v = valid[:, :, None]
    out = v & (p == F.PRED_TRUE)
    out |= v & (p == F.PRED_FWD) & (direc[:, :, None] == 0)
    out |= v & (p == F.PRED_BWD) & (direc[:, :, None] == 1)
    for code, bit in F.PRED_FLAGS:
        out |= v & (p == code) & ((flags[:, :, None] & bit) > 0)
    return out


def _field_vals(pkts: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """pkts (B, W, F), field (B, k) codes -> (B, W, k) selected field
    (0.0 for a code outside ``0..PKT_NFIELDS-1``)."""
    f = field[:, None, :]
    out = pkts.new_zeros(pkts.shape[:2] + (field.shape[1],))
    for c in range(F.PKT_NFIELDS):
        out = torch.where(f == c, pkts[..., c][:, :, None], out)
    return out


def feature_window_ref(
    pkts: torch.Tensor,       # (B, W, PKT_NFIELDS) f32
    slot_op: torch.Tensor,    # (B, k) int32 per-flow op codes (gathered by SID)
    slot_field: torch.Tensor, # (B, k) int32
    slot_pred: torch.Tensor,  # (B, k) int32
    slot_init: torch.Tensor,  # (B, k) f32
) -> torch.Tensor:
    """Branchless windowed register update; returns regs (B, k) f32."""
    mask = _pred_mask(pkts, slot_pred)                       # (B, W, k)
    val = _field_vals(pkts, slot_field)                      # (B, W, k)
    mf = mask.to(torch.float32)

    count = ordered_wsum(mf)
    total = ordered_wsum(val * mf)
    sumsq = ordered_wsum(val * val * mf)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=pkts.device)
    mx = torch.where(mask, val, -inf).amax(dim=1)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mn = torch.where(mask, val, inf).amin(dim=1)
    mn = torch.where(torch.isfinite(mn), mn, slot_init)
    W = pkts.shape[1]
    pos = torch.arange(W, dtype=torch.int64, device=pkts.device)[None, :, None]
    first_i = torch.where(mask, pos, W).amin(dim=1)
    last_i = torch.where(mask, pos, -1).amax(dim=1)
    any_ = mask.any(dim=1)
    first = torch.where(any_, torch.gather(
        val, 1, first_i.clamp(max=W - 1)[:, None, :])[:, 0, :], 0.0)
    last = torch.where(any_, torch.gather(
        val, 1, last_i.clamp(min=0)[:, None, :])[:, 0, :], 0.0)

    op = slot_op
    out = torch.zeros_like(total)
    out = torch.where(op == F.OP_COUNT, count, out)
    out = torch.where(op == F.OP_SUM, total, out)
    out = torch.where(op == F.OP_MAX, mx, out)
    out = torch.where(op == F.OP_MIN, mn, out)
    out = torch.where(op == F.OP_LAST, last, out)
    out = torch.where(op == F.OP_FIRST, first, out)
    out = torch.where(op == F.OP_SUMSQ, sumsq, out)
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# feature_update: incremental per-packet window state (flow-table serving)
# ---------------------------------------------------------------------------
#
# The live flow table folds ONE packet at a time into per-slot state
# ``(acc, seen)`` instead of rebuilding the window.  The fold is the
# same chain as feature_window_ref (docs/PARITY.md §5): the additive
# ops compute ``0.0 + x0 + x1 + ...`` where ordered_wsum computes
# ``x0 + x1 + ...`` (they differ only in the sign of a zero), MAX/MIN
# carry the ∓inf identity, FIRST latches on the seen bit and LAST
# overwrites, and finalisation applies the empty-window fallbacks.


def feature_state_init(slot_op: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blank window state for ``slot_op`` (n, k) codes: ``(acc (n, k)
    f32, seen (n, k) int32)``, MAX/MIN at ∓inf, every other op at 0.0.

    The fills take Python scalars: a ``torch.tensor`` made for a CUDA
    device is a host-to-device copy that syncs the stream, and the tick
    engine calls this once per hop round."""
    acc = torch.zeros(slot_op.shape, dtype=torch.float32,
                      device=slot_op.device)
    acc = acc.masked_fill(slot_op == F.OP_MIN, float("inf"))
    acc = acc.masked_fill(slot_op == F.OP_MAX, float("-inf"))
    return acc, torch.zeros(slot_op.shape, dtype=torch.int32,
                            device=slot_op.device)


def feature_update_ref(
    pkt: torch.Tensor,         # (n, PKT_NFIELDS) f32, ONE packet per row
    slot_op: torch.Tensor,     # (n, k) int32 (gathered by SID)
    slot_field: torch.Tensor,  # (n, k) int32
    slot_pred: torch.Tensor,   # (n, k) int32
    acc: torch.Tensor,         # (n, k) f32 running state
    seen: torch.Tensor,        # (n, k) int32 "any masked packet yet" bit
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one packet per row into the window state; returns the new
    ``(acc, seen)``.  An invalid packet leaves the state unchanged up to
    the sign of a zero."""
    mask = _pred_mask(pkt[:, None, :], slot_pred)[:, 0]      # (n, k)
    val = _field_vals(pkt[:, None, :], slot_field)[:, 0]     # (n, k)
    mf = mask.to(torch.float32)
    op = slot_op
    additive = (op == F.OP_COUNT) | (op == F.OP_SUM) | (op == F.OP_SUMSQ)
    contrib = torch.where(op == F.OP_COUNT, mf,
                          torch.where(op == F.OP_SUM, val * mf,
                                      (val * val) * mf))
    out = torch.where(additive, acc + contrib, acc)
    out = torch.where((op == F.OP_MAX) & mask, torch.maximum(acc, val), out)
    out = torch.where((op == F.OP_MIN) & mask, torch.minimum(acc, val), out)
    out = torch.where((op == F.OP_FIRST) & mask & (seen == 0), val, out)
    out = torch.where((op == F.OP_LAST) & mask, val, out)
    return out, seen | mask.to(torch.int32)


def feature_finalize_ref(
    acc: torch.Tensor,         # (n, k) f32 folded state
    seen: torch.Tensor,        # (n, k) int32
    slot_op: torch.Tensor,     # (n, k) int32
    slot_init: torch.Tensor,   # (n, k) f32 (MIN's empty-window fallback)
) -> torch.Tensor:
    """Folded state -> registers, equal to the rebuilt window's."""
    op = slot_op
    empty = seen == 0
    zero = torch.zeros((), dtype=torch.float32, device=acc.device)
    out = torch.where((op == F.OP_MAX) & empty, zero, acc)
    out = torch.where((op == F.OP_MIN) & empty, slot_init, out)
    return torch.where(((op == F.OP_FIRST) | (op == F.OP_LAST)) & empty,
                       zero, out)


def feature_update_finalize_ref(pkt, slot_op, slot_field, slot_pred,
                                slot_init, acc, seen):
    """Fold one packet per row AND finalize: ``(acc2, seen2, regs)``,
    exactly :func:`feature_update_ref` then :func:`feature_finalize_ref`
    on the new state."""
    acc2, seen2 = feature_update_ref(pkt, slot_op, slot_field, slot_pred,
                                     acc, seen)
    return acc2, seen2, feature_finalize_ref(acc2, seen2, slot_op,
                                             slot_init)


# ---------------------------------------------------------------------------
# dt_traverse: range-mark matching
# ---------------------------------------------------------------------------
def dt_traverse_ref(
    regs: torch.Tensor,        # (B, k) f32 feature registers
    thresholds: torch.Tensor,  # (B, k, T) f32 per-flow subtree thresholds (+inf pad)
    leaf_lo: torch.Tensor,     # (B, L, k) int32
    leaf_hi: torch.Tensor,     # (B, L, k) int32
    leaf_action: torch.Tensor, # (B, L) int32, -1 padding
    leaf_valid: torch.Tensor,  # (B, L) bool
) -> torch.Tensor:
    """Range-marking execution; returns action (B,) int32, -1 where no
    valid leaf matched."""
    # integer count of thresholds below each register: exact in any order
    marks = (regs[:, :, None] > thresholds).sum(dim=2, dtype=torch.int32)
    m = marks[:, None, :]                                    # (B, 1, k)
    hit = (m >= leaf_lo) & (m <= leaf_hi)                    # (B, L, k)
    hit = hit.all(dim=2) & leaf_valid                        # (B, L)
    L = hit.shape[1]
    lidx = torch.arange(L, dtype=torch.int64, device=regs.device)[None, :]
    first = torch.where(hit, lidx, L).amin(dim=1)
    safe = first.clamp(max=L - 1)
    action = torch.gather(leaf_action, 1, safe[:, None])[:, 0]
    return torch.where(first < L, action, -1).to(torch.int32)
