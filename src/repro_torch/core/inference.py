"""The partitioned-inference engine (port of ``repro.core.inference``).

Orchestrates the two data-plane phases per partition window:
  1. Feature Collection & Engineering -- fill the k registers for each
     flow's active subtree (kernel A, ``kernels.feature_window``);
  2. Subtree Model Prediction -- range-mark the registers and emit the
     action, next SID or exit class (kernel B behind the SID dispatch,
     ``kernels.dt_traverse`` / ``kernels.dispatch``).
Between partitions the engine performs the "recirculation": SID update
and register reset, counted per flow.

One device-resident walk (:func:`partition_walk`, a Python loop over the
P partitions with no host sync inside) is parameterised by the step:

* **fused** -- the plain PyTorch step (``ops.fused_step``), dense
  per-flow gathers of the SID-keyed tables; the CPU path;
* **cuda** -- the two CUDA kernels (``ops.cuda_step``); the card's path.

Both fetch the verdicts to the host once per batch, and both must equal
:meth:`PartitionedDT.predict` (the numpy oracle) and the JAX package's
engine bit for bit (docs/PARITY.md).  A flow that never takes an exit
action reports ``-1`` sentinels (labels and exit partition), counted by
``EngineResult.n_unterminated``.

Not ported yet: the looped backend, early-exit compaction, streaming
and the ``auto``/``tuned`` routing (ROADMAP items A.5, A.7, A.9).  Live
per-packet serving is ``repro_torch.serve.flowtable``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import PartitionedDT
from repro_torch.core.range_tables import pack_range_exec
from repro_torch.core.tables import pack_tables
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


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

_IMPLS = (None, "fused", "cuda")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Engine execution knobs.

    ``impl``: ``None`` (``cuda`` on a CUDA engine, ``fused`` on a CPU
    one), ``"fused"`` (plain PyTorch) or ``"cuda"`` (the kernels; a CPU
    engine refuses it).  ``block_b``: flow-block rows of the SID
    dispatch and the range-match kernel (``None`` = 128); read only by
    the ``cuda`` backend.
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


def _walk_init(B: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Initial flow-walk carry: ``(sid, done, labels, recircs, exit_p)``.

    ``labels`` / ``exit_partition`` start at the ``-1`` sentinel so a
    flow that never takes an exit action is distinguishable from a
    class-0 verdict at partition 0.
    """
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.zeros(B, **i32),                          # sid: all at root
        torch.zeros(B, dtype=torch.bool, device=device),  # done
        torch.full((B,), -1, **i32),                    # labels (sentinel)
        torch.zeros(B, **i32),                          # recircs
        torch.full((B,), -1, **i32),                    # exit_partition
    )


def _hop_update(carry, p: int, action: torch.Tensor, S: int):
    """Recirculation bookkeeping for one hop.

    Actions ``>= S`` exit with class ``action - S``; smaller actions
    recirculate to that SID.  Everything is masked by ``active``, so
    slots of flows already done may carry any action.
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


def partition_walk(
    win_pkts: torch.Tensor,      # (B, P', W, PKT_NFIELDS), P' >= P
    dev: ops.DeviceTables,
    *,
    n_subtrees: int,
    n_partitions: int,
    with_trace: bool = False,
    step: StepFn = ops.fused_step,
):
    """Device-resident partition walk over the first ``n_partitions``
    windows.

    Returns ``(labels, recircs, exit_partition, regs)`` device tensors,
    int32 except ``regs`` (P, B, k) f32, which is ``None`` unless
    ``with_trace``.  A Python loop over P with no host sync: each hop
    reads its window ``win_pkts[:, p]`` in place.
    """
    B = win_pkts.shape[0]
    carry = _walk_init(B, win_pkts.device)
    trace = []
    for p in range(n_partitions):
        regs, action = step(win_pkts[:, p], carry[0], dev)
        carry = _hop_update(carry, p, action, n_subtrees)
        if with_trace:
            trace.append(regs)
    _, _, labels, recircs, exit_p = carry
    return labels, recircs, exit_p, (torch.stack(trace) if with_trace
                                     else None)


@dataclasses.dataclass(frozen=True)
class WalkBackend:
    """The device walk with one host fetch per batch; ``fused`` and
    ``cuda`` differ only in the per-partition ``step``."""
    name: str
    step: StepFn

    def run(self, engine: "Engine", win_pkts, *,
            with_trace: bool = True) -> EngineResult:
        P = engine._check_windows(win_pkts)
        # f32 on the engine's device, as the JAX engine's jnp.asarray
        x = torch.as_tensor(win_pkts[:, :P]).to(device=engine.device,
                                                 dtype=torch.float32)
        labels, recircs, exit_p, regs = partition_walk(
            x, engine.tables.dev, n_subtrees=engine.tables.n_subtrees,
            n_partitions=P, with_trace=with_trace, step=self.step)
        # ONE device->host transfer for the whole batch: the f32 trace
        # rides along bit-cast to int32
        parts = [labels, recircs, exit_p]
        if regs is not None:
            parts.append(regs.reshape(-1).view(torch.int32))
        host = torch.cat(parts).cpu().numpy()
        B = labels.shape[0]
        labels_h, recircs_h, exit_h = (host[i * B:(i + 1) * B]
                                       for i in range(3))
        trace = []
        if regs is not None:
            trace = list(host[3 * B:].view(np.float32).reshape(regs.shape))
        return EngineResult(labels_h, recircs_h, exit_h, trace)


FUSED_BACKEND = WalkBackend(name="fused", step=ops.fused_step)


def cuda_backend(block_b: int = ops.BLOCK_B) -> WalkBackend:
    """The kernel walk with ``block_b``-row SID blocks."""
    return WalkBackend(name=f"cuda[bb={block_b}]",
                       step=ops.cuda_step(block_b))


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
        return cuda_backend(opt.block_b or ops.BLOCK_B)

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
