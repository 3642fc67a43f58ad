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
  tables, kernel A then kernel B (one launch each a hop) on the card,
  their plain versions on the CPU.

Backend selection is ``repro_torch.tuning.resolve_route``, shared with
the streaming scheduler and the flow-table server:
``EngineOptions(impl=None)`` is ``cuda`` on a CUDA engine and ``fused``
on a CPU one, a backend name forces it, ``impl="auto"`` routes through
the cost model and ``impl="tuned"`` through the cached autotuner; both
resolve a ``Plan`` (backend and compaction) for the batch's shape and
attach it to ``EngineResult.plan``.  :func:`get_backend` maps a name to
its backend.

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

Each run records the JAX engine's labelled counters into the process
registry (``repro_torch.obs``): ``engine_dispatches_total{backend}``,
``engine_hop_survivors_total{hop}`` and, for a compacted walk on the
plain hop's ladder, ``engine_compact_bucket_total{hop,cap}``; the walk
and its fetch run in the spans ``engine/dispatch`` and ``engine/fetch``.
Batches larger than one device batch stream through
``Engine.run_streaming`` (``repro_torch.serve.streaming``); live
per-packet serving is ``repro_torch.serve.flowtable``.
"""
from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.partition import PartitionedDT
from repro_torch.core.range_tables import pack_range_exec
from repro_torch.core.tables import pack_tables
from repro_torch.device import resolve_device
from repro_torch.kernels import compaction, ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.engine_hop import engine_hop_kernel, engine_hop_plain
from repro_torch.kernels.ops import StepFn  # noqa: F401  (the JAX name)


@dataclasses.dataclass
class EngineResult:
    labels: np.ndarray           # (B,) int32 class per flow; -1 if the
                                 #     flow never took an exit action
    recircs: np.ndarray          # (B,) int32 partition transitions
    exit_partition: np.ndarray   # (B,) int32 exit hop; -1 sentinel as above
    regs_trace: list[np.ndarray] # per-partition (B, k) f32 registers
    plan: "object | None" = None # repro_torch.tuning.Plan when impl="auto"/
                                 # "tuned" (or compact="auto") resolved the
                                 # route; None for a forced impl

    @property
    def n_unterminated(self) -> int:
        """Flows that never took an exit action (``-1`` sentinels)."""
        return int(np.count_nonzero(np.asarray(self.exit_partition) < 0))


# one hop of the walk, in place: (pkts (B, W, F), carry, dev, p, *,
# n_subtrees, regs_out, rows=None, n_active=None, caps=None) -> None, the
# contract of the walk backends; rows / n_active / caps compact the hop
HopFn = Callable[..., None]

_IMPLS = (None, "auto", "tuned", "ref", "fused", "cuda", "looped")

#: Streaming chunk size a device type reads when ``EngineOptions
#: .micro_batch`` is None: 65,536 flows on a card (``chip_smoke.py`` phase
#: ``stream``: the fastest chunk there, and the smallest at which the
#: upload outlasts the host's dispatch of a chunk), the JAX package's
#: 4,096 on the CPU.
MICRO_BATCH = {"cuda": 65536, "cpu": 4096}


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """All engine execution knobs, in one frozen value.

    ``Engine.run`` / ``run_looped`` / ``run_streaming`` and the serving
    layer (``repro_torch.serve``) take ``options=EngineOptions(...)``;
    each reads the knobs that apply to it and ignores the rest.

    ===============  =====================================================
    knob             meaning
    ===============  =====================================================
    impl             ``None`` (the engine's own ``impl``; if that is
                     ``None`` too, ``cuda`` on a CUDA engine and
                     ``fused`` on a CPU one), a backend (``fused``, or
                     its alias ``ref``: plain PyTorch;
                     ``cuda``: the hop kernel, CUDA engines only;
                     ``looped``: the host loop), ``"auto"`` (cost model)
                     or ``"tuned"`` (autotune cache); see
                     ``repro_torch.tuning``
    plan             a resolved ``repro_torch.tuning.Plan``; wins over
                     ``impl`` and ``compact``
    compact          early-exit compaction between hops: True/False, or
                     ``"auto"`` (the routing plan decides)
    compact_floor    smallest non-empty rung of the plain ``fused`` hop's
                     capacity ladder (the hop kernel's survivor mode and
                     the looped backend compact exactly and do not read
                     it)
    block_b          flow-block rows of the legacy tick engine's SID
                     dispatch (``FlowTableServer``); no walk reads it
    micro_batch      streaming chunk size (flows per dispatch); None =
                     ``MICRO_BATCH`` for the engine's device: 65,536 on a
                     card, where smaller chunks leave the stream bound by
                     the host's per-chunk dispatch, and the JAX
                     package's 4,096 on the CPU
    inflight         streaming pipeline depth (chunks in flight)
    donate           accepted for the JAX package's signature and not
                     read: on a card the staging and device rings of
                     ``inflight`` chunks always serve every chunk, which
                     is what donation buys there
    mesh             ``repro_torch.launch.mesh.FlowMesh`` to shard each
                     streamed chunk's flows over
    ===============  =====================================================
    """
    impl: str | None = None
    plan: "object | None" = None
    compact: bool | str = False
    compact_floor: int = compaction.COMPACT_FLOOR
    block_b: int | None = None
    micro_batch: int | None = None
    inflight: int = 2
    donate: bool | None = None
    mesh: "object | None" = None

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; options: "
                             + ", ".join(str(i) for i in _IMPLS))
        if self.compact not in (True, False, "auto"):
            raise ValueError(
                f"compact must be True, False or 'auto', got {self.compact!r}")
        if self.compact_floor <= 0:
            raise ValueError("compact_floor must be positive")
        if self.block_b is not None and self.block_b <= 0:
            raise ValueError("block_b must be positive")
        if self.micro_batch is not None and self.micro_batch <= 0:
            raise ValueError("micro_batch must be positive")
        if self.inflight <= 0:
            raise ValueError("inflight must be positive")

    def replace(self, **changes) -> "EngineOptions":
        """``dataclasses.replace`` as a method."""
        return dataclasses.replace(self, **changes)


#: Sentinel telling "legacy keyword not passed" from any real value
#: (None is meaningful for several knobs).
_UNSET = object()


def _legacy_options(options: EngineOptions | None, legacy: dict,
                    *, stacklevel: int = 3) -> EngineOptions:
    """Fold explicitly passed legacy keywords into an EngineOptions.

    The deprecation shim of ``Engine.run`` / ``run_looped`` /
    ``run_streaming``, as the JAX package's: the keywords still work but
    warn (``DeprecationWarning``), and mixing them with ``options=`` is
    an error rather than a silent precedence rule.
    """
    passed = {key: v for key, v in legacy.items() if v is not _UNSET}
    if not passed:
        return options if options is not None else EngineOptions()
    if options is not None:
        raise ValueError(
            "pass options=EngineOptions(...) OR legacy keyword(s) "
            f"({', '.join(sorted(passed))}), not both")
    warnings.warn(
        "keyword(s) " + ", ".join(sorted(passed)) + " are deprecated; "
        "use options=EngineOptions(...) instead",
        DeprecationWarning, stacklevel=stacklevel)
    return EngineOptions(**passed)


@dataclasses.dataclass(frozen=True)
class EngineTables:
    """What an :class:`Engine` runs: the device tables plus the counts
    that give them meaning."""
    dev: ops.DeviceTables
    n_subtrees: int
    n_partitions: int
    n_classes: int


def _walk_buffers(B: int, P: int, k: int, with_trace: bool,
                  device: torch.device, *, survivors: bool = False):
    """The walk's fetch buffer and its views.

    One int32 buffer of ``3 B + P B k (+ P)`` words: ``labels | recircs |
    exit_partition | trace | survivors``, the (P, B, k) f32 register
    trace bit-cast (without the trace, no words) and, with ``survivors``,
    the P flows still walking when each hop starts.  ``labels`` /
    ``exit_partition`` start at the ``-1`` sentinel so a flow that never
    takes an exit action is distinguishable from a class-0 verdict at
    partition 0.  Returns ``(buf, carry, trace)``: ``carry`` is ``(sid,
    done, labels, recircs, exit_p)`` with the last three views of
    ``buf``, every flow at the root SID 0; ``trace`` is None without the
    trace.
    """
    n_trace = P * B * k if with_trace else 0
    buf = torch.empty(3 * B + n_trace + (P if survivors else 0),
                      dtype=torch.int32, device=device)
    labels, recircs, exit_p = buf[:3 * B].view(3, B)
    labels.fill_(-1)
    recircs.zero_()
    exit_p.fill_(-1)
    if survivors:
        buf[-P:].fill_(B)             # each hop takes its done flows off
    carry = (torch.zeros(B, dtype=torch.int32, device=device),  # sid: root
             torch.zeros(B, dtype=torch.bool, device=device),   # done
             labels, recircs, exit_p)
    trace = (buf[3 * B:3 * B + n_trace].view(torch.float32).view(P, B, k)
             if with_trace else None)
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
    count_survivors: bool = False,
) -> torch.Tensor:
    """Device-resident partition walk over the first ``n_partitions``
    windows.

    Returns the walk's fetch buffer (see :func:`_walk_buffers`) on the
    windows' device.  A Python loop over P with no host sync: each hop
    reads its window ``win_pkts[:, p]`` in place and updates the carry,
    whose verdict fields live in the buffer.  ``count_survivors`` appends
    the per-hop survivor counts, made on the device with no host sync:
    each word starts at B, and the flows done after each hop but the
    last are taken off the next hop's word by the dense hop itself
    (``survivors_out``: the hop kernel counts them in the launch) or,
    after a compacted hop, summed from the carry's ``done`` flags, so
    the host records them from P fetched words.

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
                                      with_trace, win_pkts.device,
                                      survivors=count_survivors)
    if compact and trace is not None:
        trace[1:].zero_()
    caps = compaction.bucket_caps(B, compact_floor) if compact else None
    # the flows still walking as each hop starts
    left = buf[-n_partitions:] if count_survivors else None
    for p in range(n_partitions):
        kw = {}
        if compact and p:
            rows, n_active = compaction.compact_perm(carry[1])
            kw = dict(rows=rows, n_active=n_active, caps=caps)
        count = left is not None and p + 1 < n_partitions
        if count and not kw:
            kw["survivors_out"] = left[p + 1]    # the dense hop counts
        hop(win_pkts[:, p], carry, dev, p, n_subtrees=n_subtrees,
            regs_out=None if trace is None else trace[p], **kw)
        if count and "rows" in kw:
            # a compacted hop visits the survivors alone
            left[p + 1].sub_(torch.sum(carry[1], dtype=torch.int32))
    return buf


# the JAX package's names of the same walk: ``fused_partition_walk`` is
# the walk over the plain hop, and PyTorch has no buffer donation, so the
# ``_donated`` forms are the walk itself
fused_partition_walk = partition_walk
partition_walk_donated = partition_walk
fused_partition_walk_donated = partition_walk


def fetch_async(buf: torch.Tensor):
    """Start copying the walk's buffer to the host: ``(event, host)``.

    A card's buffer is copied with ``non_blocking=True`` on the current
    stream into pinned memory from PyTorch's caching host allocator, and
    an event is recorded after the copy; ``host`` (a numpy view of the
    pinned block, which it keeps alive) holds the buffer once the event
    has completed.  A CPU buffer is its own host copy, with no event.
    """
    if buf.device.type != "cuda":
        return None, buf.numpy()
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(buf.device))
    return done, host.numpy()


def fetch(buf: torch.Tensor) -> np.ndarray:
    """The walk's buffer on the host, in memory no later run touches:
    :func:`fetch_async`, then a wait on its event.  The returned array is
    a view that keeps its pinned block alive, so the block is reused only
    once every array of the result is gone."""
    done, host = fetch_async(buf)
    if done is not None:
        done.synchronize()
    return host


# each registry's engine_hop_survivors_total counters, by hop: every
# Engine.run records them, and the labelled look-up of P counters costs
# more host time than the rest of the record
_HOP_COUNTERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _hop_counter(reg, p: int):
    hops = _HOP_COUNTERS.setdefault(reg, [])
    while len(hops) <= p:
        hops.append(reg.counter(
            "engine_hop_survivors_total",
            "flows still walking when each hop starts",
            labels={"hop": str(len(hops))}))
    return hops[p]


def _record_walk(survivors, B: int, *, compact: bool,
                 compact_floor: int) -> None:
    """Record the per-hop survivor counts (the walk's fetched
    ``survivors`` words, :func:`partition_walk`) and, for a compacted
    walk on the plain hop's ladder over ``B`` flows, the rung each hop
    padded its survivors to: the JAX package's ``_record_walk``, which
    derives the same counts on the host from the B exits."""
    reg = obs.get_registry()
    caps = compaction.bucket_caps(B, compact_floor) if compact else None
    for p, s in enumerate(int(n) for n in survivors):
        _hop_counter(reg, p).inc(s)
        if caps is not None:
            cap = next(c for c in caps if c >= s)
            reg.counter(
                "engine_compact_bucket_total",
                "capacity-ladder bucket the hop's survivors padded to",
                labels={"hop": str(p), "cap": str(cap)}).inc()


@dataclasses.dataclass(frozen=True)
class WalkBackend:
    """The device walk with one host fetch per batch; routes differ only
    in the per-partition ``hop``.  ``ladder``: whether a compacted hop
    runs the plain capacity ladder (``engine_compact_bucket_total``
    counts its rungs); the hop kernel walks the exact survivors."""
    name: str
    hop: HopFn
    ladder: bool = True

    def run(self, engine: "Engine", win_pkts, *, with_trace: bool = True,
            options: EngineOptions | None = None) -> EngineResult:
        opt = options if options is not None else EngineOptions()
        P = engine._check_windows(win_pkts)
        k = engine.tables.dev.slot_op.shape[1]
        with obs.span("engine/dispatch"):
            # f32 on the engine's device, as the JAX engine's jnp.asarray;
            # the walk reads windows [:P] alone, so only a wider batch is cut
            x = win_pkts if win_pkts.shape[1] == P else win_pkts[:, :P]
            x = torch.as_tensor(x).to(device=engine.device,
                                      dtype=torch.float32)
            buf = partition_walk(
                x, engine.tables.dev, n_subtrees=engine.tables.n_subtrees,
                n_partitions=P, with_trace=with_trace, hop=self.hop,
                compact=bool(opt.compact), compact_floor=opt.compact_floor,
                count_survivors=True)
            obs.get_registry().counter(
                "engine_dispatches_total", "walk calls issued",
                labels={"backend": self.name}).inc()
        B = x.shape[0]
        with obs.span("engine/fetch"):
            # ONE device->host transfer for the whole batch: the f32
            # trace and the survivor counts ride along
            host = fetch(buf)
        labels, recircs, exit_p = (host[i * B:(i + 1) * B] for i in range(3))
        _record_walk(host[-P:], B, compact=bool(opt.compact) and self.ladder,
                     compact_floor=opt.compact_floor)
        trace = (list(host[3 * B:-P].view(np.float32).reshape(P, B, k))
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
        reg_obs = obs.get_registry()
        for p in range(P):
            reg_obs.counter(
                "engine_hop_survivors_total",
                "flows still walking when each hop starts",
                labels={"hop": str(p)}).inc(int(B - carry[1].sum()))
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
                reg_obs.counter(
                    "engine_dispatches_total", "walk calls issued",
                    labels={"backend": "looped"}).inc(2)
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
HOP_BACKEND = WalkBackend(name="cuda", hop=engine_hop_kernel, ladder=False)
LOOPED_BACKEND = LoopedBackend()

_BACKENDS = {"fused": FUSED_BACKEND, "cuda": HOP_BACKEND,
             "looped": LOOPED_BACKEND}


def backend_for_plan(plan) -> "WalkBackend | LoopedBackend":
    """The backend of a :class:`repro_torch.tuning.Plan`."""
    return _BACKENDS[plan.backend]


def get_backend(impl: str = "auto", shape=None, *,
                device: "str | torch.device | None" = None):
    """Backend selection matrix.

    ==========  =====================================================
    impl        backend
    ==========  =====================================================
    auto        with ``shape`` (a ``repro_torch.tuning.ShapeInfo``):
                the cost model's argmin for that workload on
                ``device``'s platform; without: ``cuda`` on a CUDA
                device, ``fused`` elsewhere
    tuned       resolved by ``Engine.run`` / ``run_streaming`` through
                the autotune cache; refused here (it needs an engine
                and a batch to probe)
    fused, ref  the plain PyTorch walk
    cuda        the hop-kernel walk (a CUDA device only)
    looped      the host loop, one sync a hop
    ==========  =====================================================

    ``device=None`` means the card, and raises where there is none
    (``repro_torch.device.resolve_device``); a device named explicitly
    only picks the row of the matrix.
    """
    if impl == "tuned":
        raise ValueError(
            "impl='tuned' is shape-dependent; use Engine.run / "
            "run_streaming (they resolve it through repro_torch.tuning)")
    if impl not in _IMPLS or impl is None:
        raise ValueError(f"unknown impl {impl!r}; options: auto, tuned, "
                         "ref, " + ", ".join(sorted(_BACKENDS)))
    device = resolve_device(None) if device is None else torch.device(device)
    on_card = device.type == "cuda"
    if impl == "ref":
        impl = "fused"
    if impl == "auto":
        if shape is not None:
            from repro_torch.tuning import choose_plan
            return backend_for_plan(choose_plan(
                shape, platform="cuda" if on_card else "cpu"))
        impl = "cuda" if on_card else "fused"
    if impl == "cuda" and not on_card:
        raise ValueError("impl='cuda' needs an engine on a CUDA device; "
                         f"this one is on {device}")
    return _BACKENDS[impl]


@dataclasses.dataclass
class Engine:
    """A trained model's tables on one device.  ``impl`` is the engine's
    default route, read wherever ``EngineOptions.impl`` is ``None``
    (``run``, ``run_streaming``, the flow-table server); ``None`` is the
    device's own (``cuda`` on a card, ``fused`` on the CPU)."""
    tables: EngineTables
    device: torch.device
    impl: str | None = None
    _replicas: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; options: "
                             + ", ".join(str(i) for i in _IMPLS))

    @classmethod
    def from_model(cls, pdt: PartitionedDT, impl: str | None = None,
                   device: "str | torch.device | None" = None) -> "Engine":
        """Pack a trained model and upload its tables to ``device``
        (``None`` = the card), with ``impl`` as the engine's default
        route."""
        dev = resolve_device(device)
        ret = pack_range_exec(pdt)
        return cls(tables=EngineTables(
            dev=ops.device_tables(pack_tables(pdt), ret, dev),
            n_subtrees=ret.n_subtrees, n_partitions=pdt.n_partitions,
            n_classes=ret.n_classes), device=dev, impl=impl)

    @classmethod
    def from_tables(cls, tables: EngineTables,
                    impl: str | None = None) -> "Engine":
        """An engine over already-uploaded tables (see ``convert``)."""
        return cls(tables=tables, device=tables.dev.slot_op.device,
                   impl=impl)

    def tables_on(self, device: "str | torch.device") -> ops.DeviceTables:
        """The engine's device tables on ``device``: its own on its own
        device, else a replica uploaded once and cached on the engine
        (the streaming scheduler's per-device copies)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.tables.dev.slot_op.device:
            return self.tables.dev
        rep = self._replicas.get(device)
        if rep is None:
            rep = self._replicas[device] = ops.DeviceTables(
                *(t.to(device) for t in self.tables.dev))
        return rep

    def _check_windows(self, win_pkts) -> int:
        if win_pkts.shape[1] < self.tables.n_partitions:
            raise ValueError("fewer windows than partitions")
        return self.tables.n_partitions

    def run(self, win_pkts, *, with_trace: bool = True,
            options: EngineOptions | None = None,
            impl: "str | None | object" = _UNSET,
            compact: "bool | str | object" = _UNSET) -> EngineResult:
        """``win_pkts``: (B, p, W, PKT_NFIELDS) from ``window_packets``,
        as a numpy array or a tensor (moved to the engine's device).

        ``options.plan`` (a resolved ``repro_torch.tuning.Plan``) wins
        outright; otherwise ``options.impl``, falling back to the
        engine's ``impl``: a backend name (or ``None``, the device's
        default) runs that backend, ``"auto"`` routes through
        the cost model for this batch's shape and ``"tuned"`` through the
        autotune cache (the first call on a new shape and device times a
        shortlist).  ``compact=True`` compacts between hops, ``"auto"``
        lets the plan decide.  A plan that decided the route lands on
        ``EngineResult.plan``.  Every route is bit-identical, so the
        choice changes speed, never results.  The ``impl=`` and
        ``compact=`` keywords are the JAX package's deprecated shims for
        ``options=``.
        """
        from repro_torch.tuning import resolve_route
        opt = _legacy_options(options, {"impl": impl, "compact": compact})
        name, compact, floor, plan = resolve_route(self, opt, win_pkts)
        if plan is not None:
            # the backends read compact and compact_floor alone
            opt = EngineOptions(compact=compact, compact_floor=floor)
        res = get_backend(name, device=self.device).run(
            self, win_pkts, with_trace=with_trace, options=opt)
        res.plan = plan
        return res

    def run_streaming(self, win_pkts, *,
                      options: EngineOptions | None = None,
                      micro_batch=_UNSET, donate=_UNSET, mesh=_UNSET,
                      impl=_UNSET, inflight=_UNSET,
                      compact=_UNSET) -> EngineResult:
        """Chunk ``win_pkts`` (numpy, B unbounded) into micro-batches and
        stream them through a walk backend, with ``options.inflight``
        chunks in the pipeline and, with ``options.mesh``, each chunk's
        flows sharded over the mesh's devices.  Equal to ``run(win_pkts,
        with_trace=False)``.  Legacy keywords are deprecated shims for
        ``options=``.  See ``repro_torch.serve.streaming``."""
        opt = _legacy_options(options, {
            "micro_batch": micro_batch, "donate": donate, "mesh": mesh,
            "impl": impl, "inflight": inflight, "compact": compact})
        from repro_torch.serve.streaming import run_streaming
        return run_streaming(self, win_pkts, options=opt)

    def run_looped(self, win_pkts, *, with_trace: bool = True,
                   options: EngineOptions | None = None,
                   compact=_UNSET) -> EngineResult:
        """The looped backend (``options.impl`` is not read): per-op
        kernels and one host sync per hop; ``options.compact`` compacts
        each hop after the first to the exact survivor rows (``compact=``
        is the deprecated shim)."""
        opt = _legacy_options(options, {"compact": compact})
        return LOOPED_BACKEND.run(self, win_pkts, with_trace=with_trace,
                                  options=opt)
