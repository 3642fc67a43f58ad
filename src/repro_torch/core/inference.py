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
arrays are views of that host copy, owned by the result.

* **looped** -- a host loop with one device-to-host sync per hop
  (:class:`LoopedBackend`, ``Engine.run_looped``): the carry lives on the
  host and each hop calls the per-op routes on the engine's device
  tables, kernel A then kernel B behind the SID dispatch on the card,
  their plain versions on the CPU.

Every backend takes ``compact=True``, early-exit compaction
(``kernels.compaction``): hop 0 runs dense, each later hop only on the
flows still walking, and the trace row of a hop holds zeros for the
flows done before it.  The walk compacts with the survivor-first
permutation on the device (the hop kernel's survivor mode on the card,
the plain capacity ladder on the CPU); the looped backend with exact
host fancy indexing.  Every route must equal
:meth:`PartitionedDT.predict` (the numpy oracle) and the JAX package's
engine bit for bit (docs/PARITY.md).  A flow that never takes an exit
action reports ``-1`` sentinels (labels and exit partition), counted by
``EngineResult.n_unterminated``.

Not ported yet: streaming and the ``auto``/``tuned`` routing (ROADMAP
items A.7, A.9), and the engine's labelled counters
(``engine_hop_survivors_total`` and the others, A.10).  Live per-packet
serving is ``repro_torch.serve.flowtable``.
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
from repro_torch.kernels import compaction, ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.engine_hop import engine_hop_kernel, engine_hop_plain


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


# one hop of the walk, in place: (pkts (B, W, F), carry, dev, p, *,
# n_subtrees, regs_out, rows=None, n_active=None, caps=None) -> None, the
# contract of the walk backends; rows / n_active / caps compact the hop
HopFn = Callable[..., None]

_IMPLS = (None, "fused", "cuda", "looped")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Engine execution knobs.

    ``impl``: ``None`` (``cuda`` on a CUDA engine, ``fused`` on a CPU
    one), ``"fused"`` (plain PyTorch), ``"cuda"`` (the hop kernel; a
    CPU engine refuses it) or ``"looped"`` (the host loop, per-op
    kernels on a CUDA engine).  ``compact``: early-exit compaction
    between hops (``True``/``False``; the JAX package's ``"auto"`` needs
    the cost model).  ``compact_floor``: the smallest non-empty rung of
    the plain compacted step's capacity ladder; on the card the hop
    kernel's survivor mode needs no ladder and does not read it, and the
    looped backend compacts exactly.  ``block_b``: flow-block rows of
    the SID dispatch in the JAX package's Pallas walk, kept for API
    parity: the hop kernel needs no SID dispatch and does not read it,
    the looped backend dispatches with the default (the legacy tick
    engine's range match reads it, through ``FlowTableServer``).
    """
    impl: str | None = None
    compact: bool = False
    compact_floor: int = compaction.COMPACT_FLOOR
    block_b: int | None = None

    def __post_init__(self):
        if self.impl in ("auto", "tuned"):
            raise ValueError(f"impl={self.impl!r} needs repro.tuning, which "
                             "is not ported yet (ROADMAP A.9)")
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; options: "
                             + ", ".join(str(i) for i in _IMPLS))
        if self.compact == "auto":
            raise ValueError("compact='auto' needs repro.tuning, which is "
                             "not ported yet (ROADMAP A.9)")
        if self.compact not in (True, False):
            raise ValueError(
                f"compact must be True or False, got {self.compact!r}")
        if self.compact_floor <= 0:
            raise ValueError("compact_floor must be positive")
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
    compact: bool = False,
    compact_floor: int = compaction.COMPACT_FLOOR,
) -> torch.Tensor:
    """Device-resident partition walk over the first ``n_partitions``
    windows.

    Returns the walk's fetch buffer (see :func:`_walk_buffers`) on the
    windows' device.  A Python loop over P with no host sync: each hop
    reads its window ``win_pkts[:, p]`` in place and updates the carry,
    whose verdict fields live in the buffer.

    With ``compact`` (the JAX package's ``_compacted_walk``) hop 0 runs
    dense and each later hop gets the survivor-first permutation of the
    carry's ``done`` flags and the survivor count, made on the device
    (``compaction.compact_perm``), with the ladder ``bucket_caps(B,
    compact_floor)``: the hop kernel walks the survivors alone and reads
    no ladder, the plain hop runs the compacted step.  The trace rows of
    hops 1.. are zeroed first, so a flow done before a hop reads zeros
    there.
    """
    B = win_pkts.shape[0]
    buf, carry, trace = _walk_buffers(B, n_partitions, dev.slot_op.shape[1],
                                      with_trace, win_pkts.device)
    if compact and trace is not None:
        trace[1:].zero_()
    caps = compaction.bucket_caps(B, compact_floor) if compact else None
    for p in range(n_partitions):
        survivors = {}
        if compact and p:
            rows, n_active = compaction.compact_perm(carry[1])
            survivors = dict(rows=rows, n_active=n_active, caps=caps)
        hop(win_pkts[:, p], carry, dev, p, n_subtrees=n_subtrees,
            regs_out=None if trace is None else trace[p], **survivors)
    return buf


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

    def run(self, engine: "Engine", win_pkts, *, with_trace: bool = True,
            options: EngineOptions | None = None) -> EngineResult:
        opt = options if options is not None else EngineOptions()
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
            n_partitions=P, with_trace=with_trace, hop=self.hop,
            compact=opt.compact, compact_floor=opt.compact_floor))
        labels, recircs, exit_p = (host[i * B:(i + 1) * B] for i in range(3))
        trace = (list(host[3 * B:].view(np.float32).reshape(P, B, k))
                 if with_trace else [])
        return EngineResult(labels, recircs, exit_p, trace)


@dataclasses.dataclass(frozen=True)
class LoopedBackend:
    """Host-side per-partition loop (one device-to-host sync per hop).

    The benchmark baseline and the per-op dispatch point: the carry lives
    on the host, and each hop calls ``ops.feature_window_dev`` and
    ``ops.dt_traverse_dev`` on the engine's device tables, so each
    kernel runs on its own.  A numpy input is gathered per hop on the
    host and uploaded, as the JAX loop does; a tensor is indexed on its
    device.  With ``compact`` each hop after the first runs on the exact
    survivor rows (host fancy indexing, no ladder), and the trace is
    scattered back to (B, k) with zeros.
    """
    name: str = "looped"

    def run(self, engine: "Engine", win_pkts, *, with_trace: bool = True,
            options: EngineOptions | None = None) -> EngineResult:
        # options.compact_floor is a capacity-ladder knob; the looped
        # backend compacts by exact host fancy indexing, so it has no ladder
        compact = options is not None and options.compact
        B = win_pkts.shape[0]
        P = engine._check_windows(win_pkts)
        dev = engine.tables.dev
        S = engine.tables.n_subtrees
        k = dev.slot_op.shape[1]
        on_host = isinstance(win_pkts, np.ndarray)
        if not on_host and win_pkts.device != engine.device:
            win_pkts = win_pkts.to(engine.device)
        # the host carry, int32 with -1 sentinels as the walk backends;
        # each hop's bookkeeping is ref.hop_update on it
        carry = (torch.zeros(B, dtype=torch.int32),
                 torch.zeros(B, dtype=torch.bool),
                 torch.full((B,), -1, dtype=torch.int32),
                 torch.zeros(B, dtype=torch.int32),
                 torch.full((B,), -1, dtype=torch.int32))
        regs_trace: list[np.ndarray] = []
        for p in range(P):
            rows = (np.nonzero(~carry[1].numpy())[0] if compact and p
                    else np.arange(B))
            dense = rows.size == B
            if rows.size:
                if on_host:
                    pkts = torch.from_numpy(np.ascontiguousarray(
                        win_pkts[:, p] if dense else win_pkts[rows, p]))
                else:
                    pkts = (win_pkts[:, p] if dense else win_pkts[
                        torch.from_numpy(rows).to(engine.device), p])
                pkts = pkts.to(device=engine.device, dtype=torch.float32)
                sid_d = carry[0][rows].to(engine.device)
                regs_d = ops.feature_window_dev(pkts, sid_d, dev)
                action_d = ops.dt_traverse_dev(regs_d, sid_d, dev)
                # the hop's one sync: its actions (and registers) back
                action_h = action_d.cpu()
                if with_trace:
                    regs_h = regs_d.cpu().numpy()
            if with_trace:
                if B and dense:
                    regs_trace.append(regs_h)
                else:
                    full = np.zeros((B, k), dtype=np.float32)
                    if rows.size:
                        full[rows] = regs_h
                    regs_trace.append(full)
            if not rows.size:
                continue
            action = torch.full((B,), -1, dtype=torch.int32)
            action[rows] = action_h
            carry = _ref.hop_update(carry, p, action, S)
        labels, recircs, exit_partition = (t.numpy() for t in carry[2:])
        return EngineResult(labels, recircs, exit_partition, regs_trace)


FUSED_BACKEND = WalkBackend(name="fused", hop=engine_hop_plain)
HOP_BACKEND = WalkBackend(name="cuda", hop=engine_hop_kernel)
LOOPED_BACKEND = LoopedBackend()


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

    def _backend(self, opt: EngineOptions):
        """Resolve the options against this engine's device."""
        impl = opt.impl or ("cuda" if self.device.type == "cuda"
                            else "fused")
        if impl == "fused":
            return FUSED_BACKEND
        if impl == "looped":
            return LOOPED_BACKEND
        if self.device.type != "cuda":
            raise ValueError("impl='cuda' needs an engine on a CUDA device; "
                             f"this one is on {self.device}")
        return HOP_BACKEND

    def run(self, win_pkts, *, with_trace: bool = True,
            options: EngineOptions | None = None) -> EngineResult:
        """``win_pkts``: (B, p, W, PKT_NFIELDS) from ``window_packets``,
        as a numpy array or a tensor (moved to the engine's device).

        ``options.impl`` picks the backend and ``options.compact`` turns
        on early-exit compaction (see :class:`EngineOptions`); every
        route is bit-identical, so the choice changes speed, never
        results.
        """
        opt = options if options is not None else EngineOptions()
        return self._backend(opt).run(self, win_pkts, with_trace=with_trace,
                                      options=opt)

    def run_looped(self, win_pkts, *, with_trace: bool = True,
                   options: EngineOptions | None = None) -> EngineResult:
        """The looped backend (``options.impl`` is not read): per-op
        kernels and one host sync per hop; ``options.compact`` compacts
        each hop after the first to the exact survivor rows."""
        return LOOPED_BACKEND.run(self, win_pkts, with_trace=with_trace,
                                  options=options)
