"""Device-side SID dispatch for the range-match kernel (port of
``repro.kernels.dispatch``).

The range-match kernel stages ONE subtree's tables in shared memory per
thread block, so flows are grouped into SID-homogeneous blocks first:
stable argsort by SID, per-SID counts, block-aligned segment offsets,
and a binary search that maps each capacity block back to its SID.
All of it is torch glue on the device, with no host sync: the counts
come from ``index_add_`` (``torch.bincount`` on CUDA reads its maximum
back to the host), and every shape depends only on ``(B, S, block_b)``.

Capacity bound (the MoE "expert capacity" trick applied to subtrees):
block-aligning every SID segment of B flows needs at most
``ceil(B / block_b) + S`` blocks, since each SID wastes strictly less
than one block of padding.  Padded rows carry zero registers; their
actions are computed but never gathered back (docs/PARITY.md §3).

Shapes and dtypes match the JAX package: registers f32 ``(B, k)``, SIDs
int32 ``(B,)`` in ``[0, S)``, actions int32 ``(B,)`` (``-1`` where no
leaf matched), and ``order``/``dest``/``block_sid`` int32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.dt_traverse import dt_traverse_blocks


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (ints, m > 0)."""
    return -(-n // m) * m


def pad_axis0(x, target: int):
    """Pad the leading axis with zero rows up to ``target`` (no-op if
    already there).  Zero rows are the pipeline's "invalid" encoding:
    packets with valid=0 contribute to nothing downstream.  Works on
    torch tensors and numpy arrays alike."""
    n = x.shape[0]
    if n == target:
        return x
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    if isinstance(x, torch.Tensor):
        pad = x.new_zeros((target - n,) + tuple(x.shape[1:]))
        return torch.cat([x, pad])
    return np.pad(x, ((0, target - n),) + ((0, 0),) * (x.ndim - 1))


def capacity_blocks(n_flows: int, n_subtrees: int, block_b: int) -> int:
    """Static worst-case block count for SID-grouping ``n_flows`` flows:
    ceil(B/bb) full blocks of payload plus at most one partial block of
    padding per subtree."""
    return -(-n_flows // block_b) + n_subtrees


class SidDispatch(NamedTuple):
    """Flow -> block routing plan (int32 device tensors).

    order     (B,)  flow indices sorted by SID (segment-major)
    dest      (B,)  padded-buffer slot of sorted flow i
    block_sid (nb,) SID each capacity block serves (tail blocks past the
                    last used one are clamped to a valid SID; their rows
                    are never gathered back)
    """
    order: torch.Tensor
    dest: torch.Tensor
    block_sid: torch.Tensor


def sid_dispatch(sid: torch.Tensor, *, n_subtrees: int,
                 block_b: int) -> SidDispatch:
    """Plan the SID grouping on the device (no host sync, static shapes).

    ``sid`` (B,) int32 in ``[0, n_subtrees)`` -> :class:`SidDispatch`.
    Each SID's flows land contiguously at a block-aligned offset; the
    per-block SID map is recovered by binary search over the running
    block count.  Index arithmetic runs in int64 (torch's index dtype)
    and is cast back to the JAX package's int32 at the end.
    """
    B = sid.shape[0]
    dev = sid.device
    sid64 = sid.to(torch.int64)
    counts = torch.zeros(n_subtrees, dtype=torch.int64, device=dev)
    counts.index_add_(0, sid64, torch.ones_like(sid64))       # (S,)
    bps = -(-counts // block_b)                              # blocks per SID
    block_end = torch.cumsum(bps, 0)                         # exact (int)
    block_start = block_end - bps
    seg_start = torch.cumsum(counts, 0) - counts             # sorted offsets
    order = torch.argsort(sid64, stable=True)
    ssid = sid64[order]
    rank = torch.arange(B, dtype=torch.int64, device=dev) - seg_start[ssid]
    dest = block_start[ssid] * block_b + rank
    nb = capacity_blocks(B, n_subtrees, block_b)
    block_sid = torch.searchsorted(
        block_end, torch.arange(nb, dtype=torch.int64, device=dev), right=True)
    block_sid = block_sid.clamp(max=n_subtrees - 1)
    return SidDispatch(order=order.to(torch.int32), dest=dest.to(torch.int32),
                       block_sid=block_sid.to(torch.int32))


def dispatch_dt_traverse(
    regs: torch.Tensor,         # (B, k) f32 feature registers
    sid: torch.Tensor,          # (B,) int32 active subtree per flow
    thresholds: torch.Tensor,   # (S, k, T) f32
    leaf_lo: torch.Tensor,      # (S, L, k) int32
    leaf_hi: torch.Tensor,      # (S, L, k) int32
    leaf_action: torch.Tensor,  # (S, L) int32
    leaf_valid: torch.Tensor,   # (S, L) int32 (0/1)
    *,
    block_b: int,
) -> torch.Tensor:
    """SID-grouped range match -> action (B,) int32.

    Scatter flows to capacity-padded SID blocks, run the block-level
    range match (the CUDA kernel for a CUDA tensor, its plain version
    for a CPU tensor), gather actions back to flow order."""
    B, k = regs.shape
    S = int(thresholds.shape[0])
    d = sid_dispatch(sid, n_subtrees=S, block_b=block_b)
    nb = capacity_blocks(B, S, block_b)
    order = d.order.to(torch.int64)
    dest = d.dest.to(torch.int64)
    regs_g = regs.new_zeros((nb * block_b, k))
    regs_g[dest] = regs[order]
    out = dt_traverse_blocks(d.block_sid, regs_g, thresholds, leaf_lo,
                             leaf_hi, leaf_action, leaf_valid,
                             block_b=block_b)
    action = torch.empty(B, dtype=torch.int32, device=regs.device)
    action[order] = out[dest]
    return action
