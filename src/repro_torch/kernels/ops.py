"""Public wrappers around the CUDA kernels (port of ``repro.kernels.ops``).

Each per-op entry point routes by the device of its input: a CUDA
tensor launches the hand-written kernel, a CPU tensor runs the plain
PyTorch version (``kernels.ref``).  Nothing falls back: on a CUDA tensor
the kernel runs or the call raises.

All marshalling is device-resident: per-SID slot rows are gathered by
torch indexing before the feature kernel, and the range-match kernel
sits behind the device-side SID dispatch (``kernels.dispatch``), so a
partition hop needs no host round trip.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core.range_tables import RangeExecTables
from repro_torch.core.tables import PackedTables
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dispatch import dispatch_dt_traverse
from repro_torch.kernels.dt_traverse import BLOCK_B
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


def fused_step(
    pkts: torch.Tensor,        # (B, W, PKT_NFIELDS) one partition's windows
    sid: torch.Tensor,         # (B,) int32 active subtree per flow
    dev: DeviceTables,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One partition stage in plain PyTorch: registers then action.

    Both phases are the reference math with dense per-flow gathers of
    the SID-keyed tables.  Returns ``(regs (B, k) f32, action (B,)
    int32)``.
    """
    s = sid.to(torch.int64)
    regs = _ref.feature_window_ref(
        pkts, dev.slot_op[s], dev.slot_field[s], dev.slot_pred[s],
        dev.slot_init[s])
    action = _ref.dt_traverse_ref(
        regs, dev.thresholds[s], dev.leaf_lo[s], dev.leaf_hi[s],
        dev.leaf_action[s], dev.leaf_valid[s] > 0)
    return regs, action


@functools.lru_cache(maxsize=None)
def cuda_step(block_b: int = BLOCK_B) -> StepFn:
    """The kernel partition stage (counterpart of ``pallas_step``).

    The feature kernel fills the registers from SID-gathered slot rows;
    the range-match kernel runs behind the device-side SID dispatch with
    ``block_b``-row flow blocks.  Both kernels take CUDA tensors only.
    Cached so each ``block_b`` maps to one function object.
    """
    if block_b <= 0:
        raise ValueError(f"block_b must be positive, got {block_b}")

    def step(pkts: torch.Tensor, sid: torch.Tensor, dev: DeviceTables):
        s = sid.to(torch.int64)
        regs = feature_window_kernel(
            pkts, dev.slot_op[s], dev.slot_field[s], dev.slot_pred[s],
            dev.slot_init[s])
        action = dispatch_dt_traverse(
            regs, sid, dev.thresholds, dev.leaf_lo, dev.leaf_hi,
            dev.leaf_action, dev.leaf_valid, block_b=block_b)
        return regs, action

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
    (B,): kernel B behind the SID dispatch for a CUDA tensor, the dense
    plain version for a CPU tensor."""
    d = regs.device
    thr, lo, hi, act = (torch.as_tensor(t).to(d) for t in (
        ret.thresholds, ret.leaf_lo, ret.leaf_hi, ret.leaf_action))
    val = torch.as_tensor(ret.leaf_valid).to(device=d, dtype=torch.int32)
    if d.type == "cuda":
        return dispatch_dt_traverse(regs, sid, thr, lo, hi, act, val,
                                    block_b=block_b)
    s = sid.to(torch.int64)
    return _ref.dt_traverse_ref(regs, thr[s], lo[s], hi[s], act[s],
                                val[s] > 0)
