"""The partitioned-inference engine (port of ``repro.core.inference``).

Orchestrates the two data-plane phases per partition window:
  1. Feature Collection & Engineering -- fill the k registers for each
     flow's active subtree;
  2. Subtree Model Prediction -- range-mark the registers and emit the
     action, next SID or exit class.
Between partitions the engine performs the "recirculation": SID update
and register reset, counted per flow.

One device-resident walk (:func:`partition_walk`, a Python loop over the
P partitions with no host sync inside) is parameterised by the hop:

* **fused** -- the plain PyTorch hop (``kernels.engine_hop
  .engine_hop_plain``: ``ref.engine_hop_ref``, dense per-flow gathers of
  the SID-keyed tables); the CPU path;
* **cuda** -- the hop kernel (``kernels.engine_hop.engine_hop_kernel``,
  ``csrc/engine_hop.cu``): one launch per partition does both phases and
  the recirculation; the card's path.

The walk writes labels, recircs, exit partitions and the register trace
into one int32 buffer in the layout the host fetch wants; on the card it
is copied once per batch into pinned host memory, and the returned
arrays are views of that host copy, owned by the result.  Every route
must equal :meth:`PartitionedDT.predict` (the numpy oracle) and the JAX
package's engine bit for bit (docs/PARITY.md).  A flow that never takes
an exit action reports ``-1`` sentinels (labels and exit partition),
counted by ``EngineResult.n_unterminated``.

Not ported yet: the looped backend, early-exit compaction, streaming
and the ``auto``/``tuned`` routing (ROADMAP items A.5, A.7, A.9).  Live
per-packet serving is ``repro_torch.serve.flowtable``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.partition import PartitionedDT
from repro_torch.core.range_tables import pack_range_exec
from repro_torch.core.tables import pack_tables
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.engine_hop import (
    engine_hop_kernel, engine_hop_plain, write_hop,
)


@dataclasses.dataclass
class EngineResult:
    labels: np.ndarray           # (B,) int32 class per flow; -1 if the
                                 #     flow never took an exit action
    recircs: np.ndarray          # (B,) int32 partition transitions
    exit_partition: np.ndarray   # (B,) int32 exit hop; -1 sentinel as above
    regs_trace: list[np.ndarray] # per-partition (B, k) f32 registers

    @property
    def n_unterminated(self) -> int:
        """Flows that never took an exit action (``-1`` sentinels)."""
        return int(np.count_nonzero(np.asarray(self.exit_partition) < 0))


StepFn = ops.StepFn

# one hop of the walk, in place: (pkts (B, W, F), carry, dev, p, *,
# n_subtrees, regs_out) -> None, the contract of the walk backends
HopFn = Callable[..., None]

_IMPLS = (None, "fused", "cuda")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Engine execution knobs.

    ``impl``: ``None`` (``cuda`` on a CUDA engine, ``fused`` on a CPU
    one), ``"fused"`` (plain PyTorch) or ``"cuda"`` (the hop kernel; a
    CPU engine refuses it).  ``block_b``: flow-block rows of the SID
    dispatch in the JAX package's Pallas walk, kept for API parity: the
    hop kernel needs no SID dispatch and does not read it (the legacy
    tick engine's range match does, through ``FlowTableServer``).
    """
    impl: str | None = None
    block_b: int | None = None

    def __post_init__(self):
        if self.impl in ("auto", "tuned"):
            raise ValueError(f"impl={self.impl!r} needs repro.tuning, which "
                             "is not ported yet (ROADMAP A.9)")
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; options: "
                             + ", ".join(str(i) for i in _IMPLS))
        if self.block_b is not None and self.block_b <= 0:
            raise ValueError("block_b must be positive")


@dataclasses.dataclass(frozen=True)
class EngineTables:
    """What an :class:`Engine` runs: the device tables plus the counts
    that give them meaning."""
    dev: ops.DeviceTables
    n_subtrees: int
    n_partitions: int
    n_classes: int


def _walk_buffers(B: int, P: int, k: int, with_trace: bool,
                  device: torch.device):
    """The walk's fetch buffer and its views.

    One int32 buffer of ``3 B + P B k`` words (``3 B`` without the trace):
    ``labels | recircs | exit_partition | trace``, the (P, B, k) f32
    register trace bit-cast.  ``labels`` / ``exit_partition`` start at the
    ``-1`` sentinel so a flow that never takes an exit action is
    distinguishable from a class-0 verdict at partition 0.  Returns
    ``(buf, carry, trace)``: ``carry`` is ``(sid, done, labels, recircs,
    exit_p)`` with the last three views of ``buf``, every flow at the
    root SID 0; ``trace`` is None without the trace.
    """
    buf = torch.empty(3 * B + (P * B * k if with_trace else 0),
                      dtype=torch.int32, device=device)
    labels, recircs, exit_p = buf[:3 * B].view(3, B)
    labels.fill_(-1)
    recircs.zero_()
    exit_p.fill_(-1)
    carry = (torch.zeros(B, dtype=torch.int32, device=device),  # sid: root
             torch.zeros(B, dtype=torch.bool, device=device),   # done
             labels, recircs, exit_p)
    trace = (buf[3 * B:].view(torch.float32).view(P, B, k) if with_trace
             else None)
    return buf, carry, trace


def partition_walk(
    win_pkts: torch.Tensor,      # (B, P', W, PKT_NFIELDS), P' >= P
    dev: ops.DeviceTables,
    *,
    n_subtrees: int,
    n_partitions: int,
    with_trace: bool = False,
    hop: HopFn = engine_hop_plain,
) -> torch.Tensor:
    """Device-resident partition walk over the first ``n_partitions``
    windows.

    Returns the walk's fetch buffer (see :func:`_walk_buffers`) on the
    windows' device.  A Python loop over P with no host sync: each hop
    reads its window ``win_pkts[:, p]`` in place and updates the carry,
    whose verdict fields live in the buffer.
    """
    B = win_pkts.shape[0]
    buf, carry, trace = _walk_buffers(B, n_partitions, dev.slot_op.shape[1],
                                      with_trace, win_pkts.device)
    for p in range(n_partitions):
        hop(win_pkts[:, p], carry, dev, p, n_subtrees=n_subtrees,
            regs_out=None if trace is None else trace[p])
    return buf


def step_hop(step: StepFn) -> HopFn:
    """A walk hop from a partition stage: ``step`` on the carry's SIDs,
    then ``ref.hop_update``, written in place (the two-kernel walk is
    ``step_hop(ops.cuda_step(block_b))``)."""
    def hop(pkts, carry, dev, p, *, n_subtrees, regs_out=None):
        regs, action = step(pkts, carry[0], dev)
        write_hop(carry, _ref.hop_update(carry, p, action, n_subtrees),
                  regs, regs_out)
    return hop


def fetch(buf: torch.Tensor) -> np.ndarray:
    """The walk's buffer on the host, in memory no later run touches.

    A card's buffer is copied asynchronously into pinned memory from
    PyTorch's caching host allocator, one block per call; the returned
    array is a view that keeps the block alive, so the block is reused
    only once every array of the result is gone.  A CPU buffer is its
    own host copy."""
    if buf.device.type != "cuda":
        return buf.numpy()
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    torch.cuda.current_stream(buf.device).synchronize()
    return host.numpy()


@dataclasses.dataclass(frozen=True)
class WalkBackend:
    """The device walk with one host fetch per batch; routes differ only
    in the per-partition ``hop``."""
    name: str
    hop: HopFn

    def run(self, engine: "Engine", win_pkts, *,
            with_trace: bool = True) -> EngineResult:
        P = engine._check_windows(win_pkts)
        # f32 on the engine's device, as the JAX engine's jnp.asarray
        x = torch.as_tensor(win_pkts[:, :P]).to(device=engine.device,
                                                 dtype=torch.float32)
        B = x.shape[0]
        k = engine.tables.dev.slot_op.shape[1]
        # ONE device->host transfer for the whole batch: the f32 trace
        # rides along bit-cast to int32
        host = fetch(partition_walk(
            x, engine.tables.dev, n_subtrees=engine.tables.n_subtrees,
            n_partitions=P, with_trace=with_trace, hop=self.hop))
        labels, recircs, exit_p = (host[i * B:(i + 1) * B] for i in range(3))
        trace = (list(host[3 * B:].view(np.float32).reshape(P, B, k))
                 if with_trace else [])
        return EngineResult(labels, recircs, exit_p, trace)


FUSED_BACKEND = WalkBackend(name="fused", hop=engine_hop_plain)
HOP_BACKEND = WalkBackend(name="cuda", hop=engine_hop_kernel)


@dataclasses.dataclass
class Engine:
    tables: EngineTables
    device: torch.device

    @classmethod
    def from_model(cls, pdt: PartitionedDT,
                   device: "str | torch.device | None" = None) -> "Engine":
        """Pack a trained model and upload its tables to ``device``
        (``None`` = the card)."""
        dev = resolve_device(device)
        ret = pack_range_exec(pdt)
        return cls(tables=EngineTables(
            dev=ops.device_tables(pack_tables(pdt), ret, dev),
            n_subtrees=ret.n_subtrees, n_partitions=pdt.n_partitions,
            n_classes=ret.n_classes), device=dev)

    @classmethod
    def from_tables(cls, tables: EngineTables) -> "Engine":
        """An engine over already-uploaded tables (see ``convert``)."""
        return cls(tables=tables, device=tables.dev.slot_op.device)

    def _check_windows(self, win_pkts) -> int:
        if win_pkts.shape[1] < self.tables.n_partitions:
            raise ValueError("fewer windows than partitions")
        return self.tables.n_partitions

    def _backend(self, options: EngineOptions | None) -> WalkBackend:
        """Resolve the options against this engine's device."""
        opt = options if options is not None else EngineOptions()
        impl = opt.impl or ("cuda" if self.device.type == "cuda"
                            else "fused")
        if impl == "fused":
            return FUSED_BACKEND
        if self.device.type != "cuda":
            raise ValueError("impl='cuda' needs an engine on a CUDA device; "
                             f"this one is on {self.device}")
        return HOP_BACKEND

    def run(self, win_pkts, *, with_trace: bool = True,
            options: EngineOptions | None = None) -> EngineResult:
        """``win_pkts``: (B, p, W, PKT_NFIELDS) from ``window_packets``,
        as a numpy array or a tensor (moved to the engine's device).

        ``options.impl`` picks the step (see :class:`EngineOptions`);
        every backend is bit-identical, so the choice changes speed,
        never results.
        """
        return self._backend(options).run(self, win_pkts,
                                         with_trace=with_trace)
