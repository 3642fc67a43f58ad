"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``):
the SpliDT kernels and the LM prototype's ``chunk_scan``.

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


# ---------------------------------------------------------------------------
# one engine hop: the partition stage and the walk's bookkeeping
# ---------------------------------------------------------------------------
def fused_step(pkts: torch.Tensor, sid: torch.Tensor, dev
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One partition stage in plain PyTorch: registers then action.

    ``pkts`` (B, W, PKT_NFIELDS) one partition's windows, ``sid`` (B,)
    int32 active subtree per flow (``-1`` reads row S - 1, as a negative
    index does), ``dev`` the engine's ``DeviceTables``.  Both phases are
    the reference math with dense per-flow gathers of the SID-keyed
    tables.  Returns ``(regs (B, k) f32, action (B,) int32)``.
    """
    s = sid.to(torch.int64)
    regs = feature_window_ref(pkts, dev.slot_op[s], dev.slot_field[s],
                              dev.slot_pred[s], dev.slot_init[s])
    action = dt_traverse_ref(regs, dev.thresholds[s], dev.leaf_lo[s],
                             dev.leaf_hi[s], dev.leaf_action[s],
                             dev.leaf_valid[s] > 0)
    return regs, action


def hop_update(carry, p, action: torch.Tensor, S: int):
    """The walk's recirculation bookkeeping for one hop (the JAX
    ``core.inference._hop_update``).

    ``carry`` is ``(sid, done, labels, recircs, exit_p)``.  Actions
    ``>= S`` exit with class ``action - S``; smaller actions recirculate
    to that SID.  Everything is masked by ``active``, so slots of flows
    already done may carry any action.  ``p`` is the hop index (an int,
    or a per-row tensor in the serving engines).
    """
    sid, done, labels, recircs, exit_p = carry
    is_exit = action >= S
    active = ~done
    exiting = active & is_exit
    labels = torch.where(exiting, action - S, labels)
    exit_p = torch.where(exiting, p, exit_p)
    done = done | exiting
    cont = active & ~is_exit
    # one control packet per transition; registers rebuilt next window
    recircs = recircs + cont.to(torch.int32)
    sid = torch.where(cont, action, sid)
    return sid, done, labels, recircs, exit_p


def engine_hop_ref(pkts: torch.Tensor, carry, dev, p: int, S: int):
    """One hop of the engine's walk: :func:`fused_step` on the carry's
    SIDs, then :func:`hop_update`.  The plain version of the hop kernel
    (``csrc/engine_hop.cu``).  Returns ``(carry, regs (B, k) f32)``; done
    flows' registers are computed with their frozen SID, as the trace
    holds them."""
    regs, action = fused_step(pkts, carry[0], dev)
    return hop_update(carry, p, action, S), regs


# ---------------------------------------------------------------------------
# chunk_scan: gated linear recurrence (RWKV6 / Mamba2-SSD family)
# ---------------------------------------------------------------------------
# Held to tolerances (tests/test_kernels.py), not to bits: the LM prototype
# is outside docs/PARITY.md.
def chunk_scan_ref(
    q: torch.Tensor,      # (B, T, dk)
    k: torch.Tensor,      # (B, T, dk)
    v: torch.Tensor,      # (B, T, dv)
    decay: torch.Tensor,  # (B, T, dk) in (0, 1]; per-channel data-dependent
    bonus: torch.Tensor | None = None,   # (B, dk) RWKV6 "u" or None
    state: torch.Tensor | None = None,   # (B, dk, dv) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Naive per-token recurrence (the oracle).

        S_t = diag(decay_t) S_{t-1} + k_t^T v_t
        o_t = q_t (S_{t-1} + diag(bonus) k_t^T v_t)   [RWKV6 bonus form]
    With bonus=None: o_t = q_t S_t (GLA/SSD form).

    Returns (o (B, T, dv), final_state (B, dk, dv)).
    """
    B, T, dk = q.shape
    dv = v.shape[-1]
    S = (torch.zeros((B, dk, dv), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    outs = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]            # (B, dk, dv)
        if bonus is not None:
            o = torch.einsum("bk,bkv->bv", q[:, t],
                             S + bonus[:, :, None] * kv)
            S = decay[:, t, :, None] * S + kv
        else:
            S = decay[:, t, :, None] * S + kv
            o = torch.einsum("bk,bkv->bv", q[:, t], S)
        outs.append(o)
    return torch.stack(outs, dim=1).to(v.dtype), S


def chunk_scan_chunked_ref(q, k, v, decay, bonus=None, state=None,
                           chunk: int = 64
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked (parallel-within-chunk) formulation: the plain version of
    the ``chunk_scan`` kernel (``csrc/chunk_scan.cu``).

    Step for step the JAX package's ``chunk_scan_chunked_ref``: the
    ``1e-38`` log floor, the inclusive cumsum, the mid-chunk reference
    ``cum[:, C//2]``, the +-45 clip of the centred exponents (kept as it
    is, though it changes the numbers for decays below ~exp(-90/C)),
    ``cum_q = cum - logw`` and a strictly causal mask in the bonus form,
    and the uncentred ``exp(cum_q)`` for the inter-chunk read.
    """
    B, T, dk = q.shape
    dv = v.shape[-1]
    if T % chunk != 0:
        raise ValueError(f"T={T} is no multiple of chunk={chunk}: pad T "
                         "to a chunk multiple")
    nC = T // chunk
    S = (torch.zeros((B, dk, dv), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    qc = q.reshape(B, nC, chunk, dk).float()
    kc = k.reshape(B, nC, chunk, dk).float()
    vc = v.reshape(B, nC, chunk, dv).float()
    wc = decay.reshape(B, nC, chunk, dk).float()
    u = None if bonus is None else bonus.float()

    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = torch.cumsum(logw, dim=2)              # inclusive
    total = cum[:, :, -1, :]                     # (B, nC, dk)
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device)
    # GLA: kv_s reaches o_t with decay prod_{r=s+1..t} w_r (incl. w_t);
    # bonus: o_t reads S_{t-1}, so the product excludes w_t
    mask = torch.tril(ones) if u is None else torch.tril(ones, -1)
    outs = []
    for c in range(nC):
        qi, ki, vi = qc[:, c], kc[:, c], vc[:, c]
        cumi, totali = cum[:, c], total[:, c]
        cum_q = cumi if u is None else cumi - logw[:, c]
        mref = cumi[:, chunk // 2, :][:, None, :]
        q_in = qi * torch.exp(torch.clamp(cum_q - mref, -45.0, 45.0))
        k_in = ki * torch.exp(torch.clamp(mref - cumi, -45.0, 45.0))
        d_out = torch.exp(totali[:, None, :] - cumi)
        att = torch.einsum("btk,bsk->bts", q_in, k_in)
        att = torch.where(mask[None], att, 0.0)
        o_intra = torch.einsum("bts,bsv->btv", att, vi)
        if u is not None:
            diag = torch.einsum("btk,bk,btk->bt", qi, u, ki)
            o_intra = o_intra + diag[:, :, None] * vi
        # the carried state is read with the TRUE decay from chunk start
        # (uncentred; underflow to 0 is the correct limit)
        o_inter = torch.einsum("btk,bkv->btv", qi * torch.exp(cum_q), S)
        S = torch.exp(totali)[:, :, None] * S + torch.einsum(
            "btk,btv->bkv", ki * d_out, vi)
        outs.append(o_intra + o_inter)
    o = torch.stack(outs, dim=1).reshape(B, T, dv)
    return o.to(v.dtype), S
