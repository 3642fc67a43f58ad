"""Early-exit compaction for the recirculation walk (port of
``repro.kernels.compaction``).

SpliDT's recirculation overhead is tiny because classification
confidence is front-loaded: most flows exit in the first partitions
(paper §4.4).  The dense partition walk ignores that and rebuilds every
flow's registers at every hop.  Compaction runs each hop after the first
on the flows still walking (the survivors) only:

  * :func:`compact_perm` -- survivors first in their original order, then
    the done flows in theirs, and the survivor count, as device tensors:
    an O(B) stable scatter from two prefix counts, with no sort and no
    host sync, so a compacted walk on the card can be captured in a CUDA
    graph;
  * :func:`bucket_caps` -- the JAX package's static ladder of
    power-of-two capacities ``(0, floor, 2*floor, ..., B)``;
  * :func:`compacted_step` -- the plain compacted step: the smallest rung
    that holds the survivors is gathered through the permutation, the
    partition stage runs on it and the actions (and registers) are
    scattered back.  It reads the survivor count on the host to pick the
    rung.

On the card the compacted hop is not this gather: the hop kernel takes
the permutation and the device survivor count and reads each survivor's
window in place (``kernels.engine_hop``, survivor mode), so the ladder
and its floor decide nothing there.  Every step is per flow, so any rung
and the kernel give the dense walk's verdicts bit for bit; the trace of a
hop holds zeros for the flows done before it (docs/PARITY.md).

Shapes and dtypes as in the JAX package: ``pkts`` f32 ``(B, W, F)``,
``sid`` int32 ``(B,)``, ``done`` bool ``(B,)``, registers f32 ``(B, k)``,
actions int32 ``(B,)`` with ``-1`` in slots the step did not visit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import DeviceTables, StepFn

# Default smallest non-empty bucket, the JAX package's (one Pallas flow
# block there); on the card it only shapes the plain version's ladder
COMPACT_FLOOR = 128


def bucket_caps(n_flows: int, floor: int = COMPACT_FLOOR) -> tuple[int, ...]:
    """Static capacity ladder ``(0, floor, 2*floor, ..., n_flows)``.

    Strictly increasing, ends exactly at ``n_flows`` (the full batch is
    always representable); the leading 0 is the "everyone exited" rung.
    An empty batch gets the degenerate ladder ``(0,)``.
    """
    if n_flows < 0:
        raise ValueError(f"n_flows must be non-negative, got {n_flows}")
    if floor <= 0:
        raise ValueError(f"floor must be positive, got {floor}")
    if n_flows == 0:
        return (0,)
    caps = [0]
    c = floor
    while c < n_flows:
        caps.append(c)
        c *= 2
    caps.append(n_flows)
    return tuple(caps)


def compact_perm(done: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Survivor-first permutation and survivor count: ``(perm (B,) int32,
    n_active () int32)``, both on ``done``'s device.

    Survivors keep their original order in ``perm[:n_active]``, done flows
    theirs after them (what a stable argsort on ``done`` gives).  Flow
    ``b`` lands at ``cumsum(~done)[b] - 1`` if it survives and at
    ``n_active + cumsum(done)[b] - 1`` if not; ``arange(B)`` is scattered
    there.  Integer prefix counts are exact, and nothing reads a value
    back to the host.
    """
    B = done.shape[0]
    live = ~done
    n_live = torch.cumsum(live, 0)                    # int64
    n_active = n_live[-1] if B else n_live.new_zeros(())
    pos = torch.where(done, n_active + torch.cumsum(done, 0) - 1,
                      n_live - 1)
    perm = torch.empty(B, dtype=torch.int64, device=done.device)
    perm.scatter_(0, pos, torch.arange(B, device=done.device))
    return perm.to(torch.int32), n_active.to(torch.int32)


def survivor_step(
    pkts: torch.Tensor,        # (B, W, PKT_NFIELDS) one partition's windows
    sid: torch.Tensor,         # (B,) int32 active subtree per flow
    done: torch.Tensor,        # (B,) bool
    dev: DeviceTables,
    perm: torch.Tensor,        # (B,) from compact_perm(done)
    n_active: torch.Tensor,    # () int32
    *,
    step: StepFn,
    caps: tuple[int, ...],
    with_regs: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """:func:`compacted_step` on a permutation already computed: the
    rung is read from ``n_active`` on the host."""
    B = sid.shape[0]
    k = dev.slot_op.shape[1]
    n = int(n_active)
    cap = next(c for c in caps if c >= n)
    if cap == B and B:
        # full rung: run the step dense and skip the gather/scatter round
        # trip (the step is per flow, so this is bit-identical)
        regs_c, action = step(pkts, sid, dev)
        regs = (torch.where(done[:, None], 0.0, regs_c) if with_regs
                else None)
        return regs, action
    action = torch.full((B,), -1, dtype=torch.int32, device=sid.device)
    regs = (torch.zeros((B, k), dtype=torch.float32, device=sid.device)
            if with_regs else None)
    if cap > 0:
        take = perm[:cap].to(torch.int64)
        regs_c, act_c = step(pkts[take], sid[take], dev)
        action[take] = act_c
        if with_regs:
            # capacity overhang rows (done flows dragged into the rung)
            # keep zero registers, so the trace depends only on the
            # survivor set, not on the rung
            live = (~done[take])[:, None]
            regs[take] = torch.where(live, regs_c, 0.0)
    return regs, action


def compacted_step(
    pkts: torch.Tensor,
    sid: torch.Tensor,
    done: torch.Tensor,
    dev: DeviceTables,
    *,
    step: StepFn,
    caps: tuple[int, ...],
    with_regs: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Run ``step`` on the compacted survivor prefix only (the plain
    version; the JAX package's ``compacted_step``).

    Returns ``(regs, action)`` with full-batch shapes: ``action`` (B,)
    int32 carries ``-1`` in slots the step did not visit (all masked by
    ``done`` downstream), and ``regs`` (B, k) f32 -- survivors' registers
    scattered back, zeros elsewhere -- or ``None`` when ``with_regs`` is
    False.
    """
    perm, n_active = compact_perm(done)
    return survivor_step(pkts, sid, done, dev, perm, n_active, step=step,
                         caps=caps, with_regs=with_regs)
