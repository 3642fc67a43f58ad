"""Device-resident tick engine: one ingest tick with no host sync (port
of ``repro.kernels.tick_step``).

The live flow table (``repro_torch.serve.flowtable``) keeps ALL per-flow
serving state on the device, in a :class:`TickState`: the per-slot
window registers and the walk metadata (``sid``, partition, window
bounds, packets seen, recircs, a ``retired`` bit) plus each flow's
per-partition window ``bounds``.  Row ``N`` (one past the table
capacity) is the dummy row every padded or masked scatter lands on.

* :func:`admit_rows` re-initialises newly admitted slots in one scatter,
  computing ``flows.windows.window_bounds`` in int32 on the device.
* :func:`tick_step` runs the tick's rank-major ``(R, C)`` slot/packet
  arrays as a Python loop over the R ranks.  Each rank folds one packet
  per slot (the fold-and-finalize kernel, or its plain version), then
  hops every slot whose window completed: traverse (the range-match
  kernel behind the SID dispatch, or the dense plain version) and the
  walk's own ``core.inference._hop_update`` bookkeeping.  Empty trailing
  windows (flows shorter than P packets) drain in P masked rounds.
* Verdicts accumulate in per-slot device buffers that the server fetches
  once per tick.

Nothing here reads a value back to the host, so a tick is one stream of
launches.  Unlike the JAX package, whose arrays are immutable, these
functions update the state tensors IN PLACE and return the same
:class:`TickState`.

Parity (docs/PARITY.md §5): every per-row computation is the same row
math the legacy per-rank path runs (gathers and masks route rows, they
never change values), so rows ``[:N]`` and the verdicts equal the JAX
tick engine's bit for bit.  Masked rows are routed to the dummy row with
invalidated packets; where several write it, they write identical
values, except the recirculation verdict buffer's dummy entry, which no
real row ever reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.features import PKT_IAT
from repro_torch.core.inference import _hop_update
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dispatch import dispatch_dt_traverse
from repro_torch.kernels.feature_window import feature_update_finalize_kernel

_I32 = torch.int32


class TickState(NamedTuple):
    """Device-resident per-slot serving state (``N + 1`` rows; the last
    is the dummy row)."""
    acc: torch.Tensor        # (N+1, k) f32 running window registers
    seen: torch.Tensor       # (N+1, k) int32 "matched yet" bits
    sid: torch.Tensor        # (N+1,) int32 active subtree id
    part: torch.Tensor       # (N+1,) int32 active partition index
    win_lo: torch.Tensor     # (N+1,) int32 active window start (packets)
    win_hi: torch.Tensor     # (N+1,) int32 active window end
    pkts_seen: torch.Tensor  # (N+1,) int32 packets folded so far
    recircs: torch.Tensor    # (N+1,) int32 partition transitions
    retired: torch.Tensor    # (N+1,) int32 1 = verdict emitted this epoch
    bounds: torch.Tensor     # (N+1, P, 2) int32 per-partition windows


def blank_state(dev: ops.DeviceTables, n: int):
    """Blank ``(acc, seen)`` window state for ``n`` rows at the root
    SID 0."""
    return _ref.feature_state_init(
        dev.slot_op[0][None, :].expand(n, dev.slot_op.shape[1]))


def init_tick_state(dev: ops.DeviceTables, n: int,
                    n_partitions: int) -> TickState:
    """Blank state for ``n`` rows (capacity + dummy), root SID 0."""
    acc, seen = blank_state(dev, n)
    d = dev.slot_op.device
    z = [torch.zeros(n, dtype=_I32, device=d) for _ in range(7)]
    return TickState(acc, seen, *z,
                     torch.zeros((n, n_partitions, 2), dtype=_I32, device=d))


def admit_rows(state: TickState, slots: torch.Tensor,
               lengths: torch.Tensor, dev: ops.DeviceTables) -> TickState:
    """Re-initialise newly admitted slots, in place.

    ``slots`` (m,) row indices (dummy-padded; real entries unique),
    ``lengths`` (m,) flow lengths (padding rows carry 1, so every dummy
    duplicate writes identical values).  The window bounds are
    ``flows.windows.window_bounds`` in int32: the same floor-div/min
    formula as the host's.
    """
    P = state.bounds.shape[1]
    length = lengths.to(_I32).clamp(min=1)
    base = (length // P).clamp(min=1)
    w = torch.arange(P, dtype=_I32, device=length.device)[None, :]
    lo = torch.minimum(w * base[:, None], length[:, None])
    hi = torch.minimum((w + 1) * base[:, None], length[:, None])
    hi[:, P - 1] = length
    s = slots.to(torch.int64)
    state.acc[s], state.seen[s] = blank_state(dev, s.shape[0])
    # index_fill_, not ``field[s] = 0``: a Python scalar assigned into a
    # CUDA tensor is copied from host memory and syncs the stream
    for field in (state.sid, state.part, state.pkts_seen, state.recircs,
                  state.retired):
        field.index_fill_(0, s, 0)
    state.win_lo[s] = lo[:, 0]
    state.win_hi[s] = hi[:, 0]
    state.bounds[s] = torch.stack([lo, hi], dim=-1)
    return state


def _traverse(regs, sid_rows, dev, *, cuda: bool, block_b: int):
    """Subtree traversal for one hop round: the range-match kernel behind
    the SID dispatch (``cuda``), or the dense plain version."""
    if cuda:
        return dispatch_dt_traverse(
            regs, sid_rows, dev.thresholds, dev.leaf_lo, dev.leaf_hi,
            dev.leaf_action, dev.leaf_valid, block_b=block_b)
    s = sid_rows.to(torch.int64)
    return _ref.dt_traverse_ref(
        regs, dev.thresholds[s], dev.leaf_lo[s], dev.leaf_hi[s],
        dev.leaf_action[s], dev.leaf_valid[s] > 0)


def _hop_round(st: TickState, verdicts, h, regs, complete, dev, *,
               n_subtrees: int, cuda: bool, block_b: int) -> torch.Tensor:
    """One hop for the slots in ``h`` whose ``complete`` bit is set.

    ``h`` (C,) int64 routes non-completing rows to the dummy row;
    ``regs`` (C, k) are the finalized registers of the completing rows
    (masked rows may carry anything: their traversal output is discarded
    by the ``complete`` masks).  Writes verdicts for exiting and
    fell-off-the-last-partition flows into ``verdicts`` (in place),
    advances the survivors' partition, window and SID, and returns the
    ``complete`` mask of the next drain round (flows whose new window is
    empty).  Every gather reads the state before this round's writes.
    """
    P = st.bounds.shape[1]
    dummy = st.sid.shape[0] - 1
    sid_rows, p_rows = st.sid[h], st.part[h]
    rec_rows, lo_rows, hi_rows = st.recircs[h], st.win_lo[h], st.win_hi[h]
    action = _traverse(regs, sid_rows, dev, cuda=cuda, block_b=block_b)
    neg = torch.full_like(sid_rows, -1)
    sid2, done2, labels, rec2, exit_p = _hop_update(
        (sid_rows, ~complete, neg, rec_rows, neg), p_rows, action,
        n_subtrees)
    exited = complete & done2
    fell = complete & ~done2 & (p_rows == P - 1)
    adv = complete & ~done2 & (p_rows < P - 1)

    # verdict buffers: one row per slot; a slot finishes at most once per
    # tick (admission precedes folding, so no slot is reused in a tick)
    vslot = torch.where(exited | fell, h, dummy)
    vm, vl, vr, ve = verdicts
    vm.index_fill_(0, vslot, 1)           # no host-scalar copy, no sync
    vl[vslot] = labels                    # -1 unless the flow exited
    vr[vslot] = rec2
    ve[vslot] = exit_p                    # -1 unless the flow exited
    st.retired.index_fill_(0, vslot, 1)

    # survivors advance to the next partition's window; finished rows
    # keep their metadata (the host frees their slots after the fetch)
    new_part = torch.where(adv, p_rows + 1, p_rows)
    nb = st.bounds[h, new_part.clamp(max=P - 1).to(torch.int64)]  # (C, 2)
    new_lo = torch.where(adv, nb[:, 0], lo_rows)
    new_hi = torch.where(adv, nb[:, 1], hi_rows)
    st.acc[h], st.seen[h] = _ref.feature_state_init(
        dev.slot_op[sid2.to(torch.int64)])
    st.sid[h] = sid2
    st.part[h] = new_part
    st.win_lo[h] = new_lo
    st.win_hi[h] = new_hi
    st.recircs[h] = rec2
    return adv & (new_lo == new_hi)


def tick_step(state: TickState, slots_rc: torch.Tensor,
              pkt_rc: torch.Tensor, dev: ops.DeviceTables, *,
              n_subtrees: int, cuda: bool, block_b: int):
    """One ingest tick: fold every rank, hop every completed window.

    ``slots_rc`` (R, C) int32 rank-major slot indices (dummy-padded;
    within a rank each real slot appears at most once) and ``pkt_rc``
    (R, C, F) f32 the matching packets.  Rank order is per-flow arrival
    order, the reduction order the parity contract pins.  ``cuda`` runs
    the fold-and-finalize kernel and the range-match kernel; otherwise
    their plain versions.  Updates ``state`` in place and returns it with
    ``(verdict_mask, labels, recircs, exit_partition, recircs_snapshot)``,
    each ``(N,)`` int32 on the device: rows with ``verdict_mask == 1``
    finished this tick (exit or fell-off sentinels), and
    ``recircs_snapshot`` mirrors the live recirculation counts for the
    host's flush and timeout sentinels.
    """
    st = state
    N1 = st.sid.shape[0]
    P = st.bounds.shape[1]
    dummy = N1 - 1
    d = st.sid.device
    verdicts = (torch.zeros(N1, dtype=_I32, device=d),
                torch.full((N1,), -1, dtype=_I32, device=d),
                torch.zeros(N1, dtype=_I32, device=d),
                torch.full((N1,), -1, dtype=_I32, device=d))
    fold = (feature_update_finalize_kernel if cuda
            else _ref.feature_update_finalize_ref)
    for r in range(slots_rc.shape[0]):
        slots = slots_rc[r].to(torch.int64)
        # a flow that finished earlier this tick must not fold its late
        # packets (malformed flow_len) into the slot's state: the
        # retired bit is the device form of the host's key check
        live = (slots != dummy) & (st.retired[slots] == 0)
        s = torch.where(live, slots, dummy)
        pkt = torch.where(live[:, None], pkt_rc[r], 0.0)
        # window boundary clears the dependency chain (first-packet
        # IAT = 0), matching flows.windows.window_packets
        first = st.pkts_seen[s] == st.win_lo[s]
        pkt[:, PKT_IAT] = torch.where(first, 0.0, pkt[:, PKT_IAT])
        sid_rows = st.sid[s].to(torch.int64)
        acc2, seen2, regs = fold(
            pkt, dev.slot_op[sid_rows], dev.slot_field[sid_rows],
            dev.slot_pred[sid_rows], dev.slot_init[sid_rows], st.acc[s],
            st.seen[s])
        st.pkts_seen.index_add_(0, s, live.to(_I32))
        st.acc[s] = acc2
        st.seen[s] = seen2
        complete = live & (st.pkts_seen[s] == st.win_hi[s])

        # the window-completing hop uses the registers the fold just
        # finalized; drain rounds only ever see empty windows, whose
        # registers finalize from blank state
        comp = _hop_round(st, verdicts, torch.where(complete, s, dummy),
                          regs, complete, dev, n_subtrees=n_subtrees,
                          cuda=cuda, block_b=block_b)
        # The JAX loop drains while any row completes, at most P trips.
        # Here every one of the P rounds runs, with no host sync: a round
        # whose mask is all false routes every row to the dummy row N and
        # writes nothing else, so rows [:N] stay bit-identical to JAX.
        for _ in range(P):
            hh = torch.where(comp, s, dummy)
            sid_h = st.sid[hh].to(torch.int64)
            regs = _ref.feature_finalize_ref(
                st.acc[hh], st.seen[hh], dev.slot_op[sid_h],
                dev.slot_init[sid_h])
            comp = _hop_round(st, verdicts, hh, regs, comp, dev,
                              n_subtrees=n_subtrees, cuda=cuda,
                              block_b=block_b)
    N = N1 - 1
    vm, vl, vr, ve = verdicts
    return st, (vm[:N], vl[:N], vr[:N], ve[:N], st.recircs[:N])
