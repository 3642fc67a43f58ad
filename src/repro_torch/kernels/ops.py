"""Public wrappers around the CUDA kernels (port of ``repro.kernels.ops``).

Each per-op entry point routes by the device of its input: a CUDA
tensor launches the hand-written kernel, a CPU tensor runs the plain
PyTorch version (``kernels.ref``).  Nothing falls back: on a CUDA tensor
the kernel runs or the call raises.

The engine's walk on the card runs one hop kernel per partition
(``kernels.engine_hop``), which reads the SID-keyed tables itself.  The
per-op routes on the engine's :class:`DeviceTables`,
:func:`feature_window_dev` (kernel A on SID-gathered slot rows) and
:func:`dt_traverse_dev` (kernel B's per-flow form, one launch), carry
the looped backend (``Engine.run_looped``) one op at a time, and make up
the two-kernel stage :func:`cuda_step`, which stays callable beside the
hop kernel.  :func:`feature_window` and
:func:`dt_traverse` take host ``PackedTables`` / ``RangeExecTables`` and
upload them per call.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core.range_tables import RangeExecTables
from repro_torch.core.tables import PackedTables
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chunk_scan import DEFAULT_CHUNK, chunk_scan_kernel
from repro_torch.kernels.dispatch import dispatch_dt_traverse
from repro_torch.kernels.dt_traverse import BLOCK_B, dt_traverse_flows_ref
from repro_torch.kernels.feature_window import (
    feature_update_finalize_kernel, feature_update_kernel,
    feature_window_kernel,
)


# ---------------------------------------------------------------------------
# device tables -- the device-resident form of the MAT programs
# ---------------------------------------------------------------------------
class DeviceTables(NamedTuple):
    """All MAT contents as device tensors, indexable by SID.

    The engine's working set: operator-selection rows (``slot_*``) and
    range-execution tables (``thresholds`` / ``leaf_*``) stay on the
    device for the whole partition walk, so the only host<->device
    traffic per batch is the packet windows in and the verdicts out.
    """
    slot_op: torch.Tensor      # (S, k) int32
    slot_field: torch.Tensor   # (S, k) int32
    slot_pred: torch.Tensor    # (S, k) int32
    slot_init: torch.Tensor    # (S, k) f32
    thresholds: torch.Tensor   # (S, k, T) f32, +inf padded
    leaf_lo: torch.Tensor      # (S, L, k) int32
    leaf_hi: torch.Tensor      # (S, L, k) int32
    leaf_action: torch.Tensor  # (S, L) int32, -1 padding
    leaf_valid: torch.Tensor   # (S, L) int32 (0/1)


#: the nine fields with the dtype each must have
DEVICE_TABLE_DTYPES = {
    "slot_op": torch.int32, "slot_field": torch.int32,
    "slot_pred": torch.int32, "slot_init": torch.float32,
    "thresholds": torch.float32, "leaf_lo": torch.int32,
    "leaf_hi": torch.int32, "leaf_action": torch.int32,
    "leaf_valid": torch.int32,
}


def device_tables(tables: PackedTables, ret: RangeExecTables,
                  device: "str | torch.device") -> DeviceTables:
    """Upload the packed host tables once; reuse across every batch."""
    host = dict(
        slot_op=tables.slot_op, slot_field=tables.slot_field,
        slot_pred=tables.slot_pred, slot_init=tables.slot_init,
        thresholds=ret.thresholds, leaf_lo=ret.leaf_lo, leaf_hi=ret.leaf_hi,
        leaf_action=ret.leaf_action, leaf_valid=ret.leaf_valid)
    return DeviceTables(**{
        name: torch.as_tensor(host[name]).to(device=device, dtype=dt)
        for name, dt in DEVICE_TABLE_DTYPES.items()})


# one partition stage: (pkts (B, W, F), sid (B,), dev) ->
# (regs (B, k), action (B,)) -- the contract of the engine's walk backends
StepFn = Callable[[torch.Tensor, torch.Tensor, DeviceTables],
                  tuple[torch.Tensor, torch.Tensor]]


#: the plain partition stage (registers then action by dense per-flow
#: gathers of the SID-keyed tables); ``cuda_step`` is the kernels' stage
fused_step: StepFn = _ref.fused_step


@functools.lru_cache(maxsize=None)
def cuda_step(block_b: int = BLOCK_B) -> StepFn:
    """The two-kernel partition stage (counterpart of ``pallas_step``).

    The feature kernel fills the registers from SID-gathered slot rows;
    the range-match kernel matches each flow against its own subtree
    (one launch; ``block_b`` is validated and decides nothing of the
    result).  Both kernels take CUDA tensors only.
    ``Engine.run`` runs the hop kernel instead; this stage stays so the
    two walks can be timed side by side (``chip_smoke.py``).  Cached so
    each ``block_b`` maps to one function object.
    """
    if block_b <= 0:
        raise ValueError(f"block_b must be positive, got {block_b}")

    def step(pkts: torch.Tensor, sid: torch.Tensor, dev: DeviceTables):
        if pkts.device.type != "cuda":
            raise ValueError(f"cuda_step needs CUDA tensors, got "
                             f"{pkts.device}")
        regs = feature_window_dev(pkts, sid, dev)
        return regs, dt_traverse_dev(regs, sid, dev, block_b=block_b)

    step.__name__ = step.__qualname__ = f"cuda_step_bb{block_b}"
    return step


# ---------------------------------------------------------------------------
# per-op entry points
# ---------------------------------------------------------------------------
def feature_window_rows(pkts, slot_op, slot_field, slot_pred, slot_init
                        ) -> torch.Tensor:
    """Registers from pre-gathered slot rows: kernel A for a CUDA
    tensor, ``feature_window_ref`` for a CPU tensor."""
    if pkts.device.type == "cuda":
        return feature_window_kernel(pkts, slot_op, slot_field, slot_pred,
                                     slot_init)
    return _ref.feature_window_ref(pkts, slot_op, slot_field, slot_pred,
                                   slot_init)


def _table_rows(sid: torch.Tensor, S: int) -> torch.Tensor:
    """Table rows of the SIDs, int64: ``-1`` (a hop that matched no
    leaf) is row ``S - 1``, as a negative index reads it in the JAX
    package and in the hop kernel."""
    s = sid.to(torch.int64)
    return torch.where(s < 0, s + S, s)


def feature_window_dev(pkts: torch.Tensor, sid: torch.Tensor,
                       dev: DeviceTables) -> torch.Tensor:
    """Registers (B, k) of each flow's active subtree, from the engine's
    device tables: the slot rows gathered by SID, then kernel A for a
    CUDA tensor, ``feature_window_ref`` for a CPU tensor."""
    s = _table_rows(sid, dev.slot_op.shape[0])
    return feature_window_rows(pkts, dev.slot_op[s], dev.slot_field[s],
                               dev.slot_pred[s], dev.slot_init[s])


def dt_traverse_dev(regs: torch.Tensor, sid: torch.Tensor,
                    dev: DeviceTables, *, block_b: int = BLOCK_B
                    ) -> torch.Tensor:
    """Range-mark match against the engine's device tables -> action
    (B,) int32: one launch of kernel B's per-flow form for a CUDA tensor
    (through ``dispatch_dt_traverse``; the kernel wraps a SID of ``-1``
    to row ``S - 1`` itself), its plain version for a CPU tensor."""
    tables = (dev.thresholds, dev.leaf_lo, dev.leaf_hi, dev.leaf_action,
              dev.leaf_valid)
    if regs.device.type == "cuda":
        return dispatch_dt_traverse(regs, sid.to(torch.int32), *tables,
                                    block_b=block_b)
    return dt_traverse_flows_ref(regs, sid, *tables)


def feature_update(pkt, slot_op, slot_field, slot_pred, acc, seen
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one packet per row into ``(acc, seen)``: the fold kernel for a
    CUDA tensor, ``feature_update_ref`` for a CPU tensor."""
    if pkt.device.type == "cuda":
        return feature_update_kernel(pkt, slot_op, slot_field, slot_pred,
                                     acc, seen)
    return _ref.feature_update_ref(pkt, slot_op, slot_field, slot_pred, acc,
                                   seen)


def feature_update_finalize(pkt, slot_op, slot_field, slot_pred, slot_init,
                            acc, seen
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fold one packet per row and finalize: ``(acc2, seen2, regs)`` from
    the fold-and-finalize kernel for a CUDA tensor,
    ``feature_update_finalize_ref`` for a CPU tensor."""
    if pkt.device.type == "cuda":
        return feature_update_finalize_kernel(
            pkt, slot_op, slot_field, slot_pred, slot_init, acc, seen)
    return _ref.feature_update_finalize_ref(pkt, slot_op, slot_field,
                                            slot_pred, slot_init, acc, seen)


def feature_window(
    pkts: torch.Tensor,        # (B, W, PKT_NFIELDS)
    sid: torch.Tensor,         # (B,) int32
    tables: PackedTables,
) -> torch.Tensor:
    """Compute the k feature registers for each flow's active subtree."""
    s = sid.to(torch.int64)
    rows = [torch.as_tensor(t).to(pkts.device)[s] for t in (
        tables.slot_op, tables.slot_field, tables.slot_pred,
        tables.slot_init)]
    return feature_window_rows(pkts, *rows)


def dt_traverse(
    regs: torch.Tensor,        # (B, k)
    sid: torch.Tensor,         # (B,) int32
    ret: RangeExecTables,
    *,
    block_b: int = BLOCK_B,
) -> torch.Tensor:
    """Range-mark match each flow against its active subtree -> action
    (B,): kernel B's per-flow form for a CUDA tensor, its plain version
    for a CPU tensor."""
    d = regs.device
    thr, lo, hi, act = (torch.as_tensor(t).to(d) for t in (
        ret.thresholds, ret.leaf_lo, ret.leaf_hi, ret.leaf_action))
    val = torch.as_tensor(ret.leaf_valid).to(device=d, dtype=torch.int32)
    if d.type == "cuda":
        return dispatch_dt_traverse(regs, sid, thr, lo, hi, act, val,
                                    block_b=block_b)
    return dt_traverse_flows_ref(regs, sid, thr, lo, hi, act, val)


# ---------------------------------------------------------------------------
# chunk_scan
# ---------------------------------------------------------------------------
class NoBackwardError(RuntimeError):
    """A kernel was asked to run where autograd would need its backward,
    which it does not have."""


def require_no_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise :class:`NoBackwardError` when grad mode is on and any of
    ``tensors`` requires grad: a kernel launched through ``ctypes`` writes
    outputs with no ``grad_fn``, so its inputs would silently get no
    gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{name}: the CUDA kernel has no backward (as the JAX "
            f"package's Pallas kernel has none), and an input requires "
            f"grad; run it under torch.no_grad() for inference, or on "
            f"the CPU's plain version (or impl='ref') to differentiate")


def chunk_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    decay: torch.Tensor,
    bonus: torch.Tensor | None = None,
    state: torch.Tensor | None = None,
    *,
    chunk: int = DEFAULT_CHUNK,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated linear recurrence over (B, T, d) inputs; see
    ``kernels/chunk_scan.py``.  Returns ``(o (B, T, dv), state)``.

    ``impl=None`` launches the kernel for a CUDA tensor and runs the plain
    chunked version (``ref.chunk_scan_chunked_ref``) for a CPU tensor;
    ``"ref"`` runs the plain version on either device (the checks on the
    card compare the two).  The kernel has no backward, so under grad
    mode an input that requires grad makes the kernel route raise
    :class:`NoBackwardError` rather than return outputs that drop the
    gradient.  As in the JAX package: ``state=None``
    is f32 zeros, the GLA form runs unless a bonus is given, a T of at
    most ``chunk`` runs as one chunk of C = T, and a longer T that is no
    multiple of ``chunk`` is padded with zero q/k/v and decay 1.0 steps
    (which leave the state as it is), its ``o`` cut back to T.
    """
    if impl not in (None, "ref"):
        raise ValueError(f"unknown impl {impl!r}; use None or 'ref'")
    if impl is None and q.device.type == "cuda":
        require_no_grad("chunk_scan", q, k, v, decay, bonus, state)
    B, T, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = torch.zeros((B, dk, dv), dtype=torch.float32,
                            device=q.device)
    pad = (-T) % chunk if T > chunk else 0
    if pad:
        zq = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad))
        q, k, v = zq(q), zq(k), zq(v)
        decay = torch.nn.functional.pad(decay, (0, 0, 0, pad), value=1.0)
    if impl is None and q.device.type == "cuda":
        f32 = lambda x: x.to(torch.float32).contiguous()
        b = (f32(bonus) if bonus is not None
             else torch.zeros((B, dk), dtype=torch.float32, device=q.device))
        o, s = chunk_scan_kernel(f32(q), f32(k), f32(v), f32(decay), b,
                                 f32(state), chunk=chunk,
                                 use_bonus=bonus is not None)
        o = o.to(v.dtype)
    else:
        o, s = _ref.chunk_scan_chunked_ref(q, k, v, decay, bonus, state,
                                           chunk=min(chunk, q.shape[1]))
    return (o[:, :T] if pad else o), s
