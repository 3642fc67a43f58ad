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
  arrays.  On the card (``cuda=True``) that is ONE launch of the tick
  kernel (``csrc/tick_step.cu``, :func:`tick_step_kernel`): one thread
  per column walks the column's ranks in order with the slot's row in
  registers.  Its plain version (``cuda=False``) is a Python loop over
  the R ranks: each rank folds one packet per slot
  (``ref.feature_update_finalize_ref``), then hops every slot whose
  window completed (the dense ``ref.dt_traverse_ref`` and the walk's own
  ``ref.hop_update`` bookkeeping); empty trailing windows
  (flows shorter than P packets) drain in P masked rounds.
* Verdicts accumulate in per-slot device buffers that the server fetches
  once per tick.

Nothing here reads a value back to the host, so a tick is one stream of
launches.  Unlike the JAX package, whose arrays are immutable, these
functions update the state tensors IN PLACE and return the same
:class:`TickState`.

Parity (docs/PARITY.md §5): every per-row computation is the same row
math as the legacy per-rank path (gathers and masks route rows, they
never change values), so rows ``[:N]`` and the verdicts equal the JAX
tick engine's bit for bit.  In the plain loop masked rows are routed to
the dummy row with invalidated packets; where several write it, they
write identical values, except the recirculation verdict buffer's dummy
entry, which no real row ever reads.  The kernel writes nothing to the
dummy row.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.features import N_FEATURES, PKT_IAT, PKT_NFIELDS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dispatch import dispatch_dt_traverse
from repro_torch.kernels.dt_traverse import dt_traverse_flows_ref

_I32 = torch.int32

#: tick-kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the serving path)
tick_launches = 0

#: the largest k (feature slots per subtree) the tick kernel takes, every
#: k a model can have (``csrc/tick_step.cu`` kMaxK): its per-thread row is
#: templated on k for 1..8 (registers) and on a capacity of 16, 32 or 41
#: above (local memory)
K_MAX = N_FEATURES

_SOURCE = "tick_step.cu"


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


def _dense_traverse(regs, sid_rows, dev):
    """The range match's plain version over each row's own subtree."""
    return dt_traverse_flows_ref(regs, sid_rows, dev.thresholds,
                                 dev.leaf_lo, dev.leaf_hi, dev.leaf_action,
                                 dev.leaf_valid)


def _traverse(regs, sid_rows, dev, *, cuda: bool, block_b: int):
    """Subtree traversal for one hop round of the legacy tick engine: one
    launch of the range-match kernel's per-flow form (``cuda``), or its
    plain version."""
    if cuda:
        return dispatch_dt_traverse(
            regs, sid_rows, dev.thresholds, dev.leaf_lo, dev.leaf_hi,
            dev.leaf_action, dev.leaf_valid, block_b=block_b)
    return _dense_traverse(regs, sid_rows, dev)


def _hop_round(st: TickState, verdicts, h, regs, complete, dev, *,
               n_subtrees: int) -> torch.Tensor:
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
    action = _dense_traverse(regs, sid_rows, dev)
    neg = torch.full_like(sid_rows, -1)
    sid2, done2, labels, rec2, exit_p = _ref.hop_update(
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


def _verdict_buffers(n: int, device) -> tuple[torch.Tensor, ...]:
    """The four per-slot verdict buffers of one tick: mask 0, labels -1,
    recircs 0, exit partition -1."""
    return (torch.zeros(n, dtype=_I32, device=device),
            torch.full((n,), -1, dtype=_I32, device=device),
            torch.zeros(n, dtype=_I32, device=device),
            torch.full((n,), -1, dtype=_I32, device=device))


def _rank_loop(st: TickState, slots_rc, pkt_rc, dev, verdicts, *,
               n_subtrees: int) -> None:
    """The tick kernel's plain version: rank by rank, fold then hop, in
    place."""
    dummy = st.sid.shape[0] - 1
    P = st.bounds.shape[1]
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
        acc2, seen2, regs = _ref.feature_update_finalize_ref(
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
                          regs, complete, dev, n_subtrees=n_subtrees)
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
                              n_subtrees=n_subtrees)


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.tick_step_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tick_step_launch.argtypes = (
            [p, p, i, i] + [p] * 10 + [i, i] + [p] * 9 + [i] * 5
            + [p] * 4 + [p])
        lib.tick_step_launch.restype = ctypes.c_int
        lib.tick_step_k_max.argtypes = []
        lib.tick_step_k_max.restype = ctypes.c_int
        lib.tick_step_error_string.argtypes = [ctypes.c_int]
        lib.tick_step_error_string.restype = ctypes.c_char_p
        if lib.tick_step_k_max() != K_MAX:
            raise RuntimeError(f"csrc/{_SOURCE} takes k up to "
                               f"{lib.tick_step_k_max()}, K_MAX is {K_MAX}")
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(
            f"{name}: need a contiguous {dtype} {shape} tensor on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def tick_step_kernel(state: TickState, slots_rc: torch.Tensor,
                     pkt_rc: torch.Tensor, dev: ops.DeviceTables, *,
                     n_subtrees: int) -> tuple[torch.Tensor, ...]:
    """Launch the tick kernel on the current stream: one whole tick, in
    place on ``state``; returns the four ``(N + 1,)`` int32 verdict
    buffers ``(mask, labels, recircs, exit_partition)`` (the dummy
    entry N stays at its fill).

    Precondition: a real slot appears in ONE column of ``slots_rc`` (the
    flow table's pack puts each flow in one column, the same at every
    rank, and checks it), and every entry lies in ``[0, N]``, N being the
    dummy row.  The kernel gives each column to one thread, so a slot in
    two columns would be raced on.  Takes CUDA tensors only and k (slots
    per subtree) up to :data:`K_MAX`; raises on anything else and on a
    failed launch.
    """
    global tick_launches
    k = state.acc.shape[1] if state.acc.dim() == 2 else -1
    if not 1 <= k <= K_MAX:
        raise ValueError(f"tick_step_kernel takes k in 1..{K_MAX} feature "
                         f"slots (K_MAX), got k={k}")
    d = state.sid.device
    if d.type != "cuda":
        raise ValueError(f"tick_step_kernel needs CUDA tensors, got {d}; "
                         "tick_step(cuda=False) is the plain version")
    N1 = state.sid.shape[0]
    P = state.bounds.shape[1] if state.bounds.dim() == 3 else -1
    R, C = slots_rc.shape if slots_rc.dim() == 2 else (-1, -1)
    S, _, T = dev.thresholds.shape
    L = dev.leaf_lo.shape[1]
    f32, i32 = torch.float32, _I32
    for name, x, dt, shape in (
            ("slots_rc", slots_rc, i32, (R, C)),
            ("pkt_rc", pkt_rc, f32, (R, C, PKT_NFIELDS)),
            ("acc", state.acc, f32, (N1, k)),
            ("seen", state.seen, i32, (N1, k)),
            *((f, getattr(state, f), i32, (N1,)) for f in (
                "sid", "part", "win_lo", "win_hi", "pkts_seen", "recircs",
                "retired")),
            ("bounds", state.bounds, i32, (N1, P, 2)),
            ("slot_op", dev.slot_op, i32, (S, k)),
            ("slot_field", dev.slot_field, i32, (S, k)),
            ("slot_pred", dev.slot_pred, i32, (S, k)),
            ("slot_init", dev.slot_init, f32, (S, k)),
            ("thresholds", dev.thresholds, f32, (S, k, T)),
            ("leaf_lo", dev.leaf_lo, i32, (S, L, k)),
            ("leaf_hi", dev.leaf_hi, i32, (S, L, k)),
            ("leaf_action", dev.leaf_action, i32, (S, L)),
            ("leaf_valid", dev.leaf_valid, i32, (S, L))):
        _check(name, x, dt, shape, d)
    if pkt_rc.data_ptr() % 8:
        raise ValueError("pkt_rc: the kernel reads packets as 8-byte pairs "
                         "and needs an 8-byte-aligned tensor")
    verdicts = _verdict_buffers(N1, d)
    if R == 0 or C == 0:
        return verdicts
    lib = _lib()
    stream = torch.cuda.current_stream(d).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    st = state
    err = lib.tick_step_launch(
        *ptr(slots_rc, pkt_rc), R, C,
        *ptr(st.acc, st.seen, st.sid, st.part, st.win_lo, st.win_hi,
             st.pkts_seen, st.recircs, st.retired, st.bounds), N1 - 1, P,
        *ptr(*dev), S, k, T, L, n_subtrees, *ptr(*verdicts), stream)
    if err != 0:
        msg = lib.tick_step_error_string(err).decode()
        raise RuntimeError(f"tick_step kernel launch failed: {msg}")
    tick_launches += 1
    return verdicts


def tick_step(state: TickState, slots_rc: torch.Tensor,
              pkt_rc: torch.Tensor, dev: ops.DeviceTables, *,
              n_subtrees: int, cuda: bool):
    """One ingest tick: fold every rank, hop every completed window.

    ``slots_rc`` (R, C) int32 rank-major slot indices (dummy-padded;
    within a rank each real slot appears at most once) and ``pkt_rc``
    (R, C, F) f32 the matching packets.  Rank order is per-flow arrival
    order, the reduction order the parity contract pins.  ``cuda`` makes
    one launch of the tick kernel (:func:`tick_step_kernel`, whose
    precondition applies: each real slot in one column; CUDA tensors
    only, no fallback); otherwise the plain rank loop runs.  Updates
    ``state`` in place and returns it with ``(verdict_mask, labels,
    recircs, exit_partition, recircs_snapshot)``, each ``(N,)`` int32 on
    the device: rows with ``verdict_mask == 1`` finished this tick (exit
    or fell-off sentinels), and ``recircs_snapshot`` mirrors the live
    recirculation counts for the host's flush and timeout sentinels.
    """
    st = state
    if cuda:
        verdicts = tick_step_kernel(st, slots_rc, pkt_rc, dev,
                                    n_subtrees=n_subtrees)
    else:
        verdicts = _verdict_buffers(st.sid.shape[0], st.sid.device)
        _rank_loop(st, slots_rc, pkt_rc, dev, verdicts,
                   n_subtrees=n_subtrees)
    N = st.sid.shape[0] - 1
    vm, vl, vr, ve = verdicts
    return st, (vm[:N], vl[:N], vr[:N], ve[:N], st.recircs[:N])
