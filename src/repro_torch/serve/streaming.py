"""Streaming batch scheduler for the partition walk (port of
``repro.serve.streaming``).

Operators hand the engine captures of millions of flows as host arrays,
more than one device batch holds.  This module cuts such a batch into
micro-batches of ``micro_batch`` flows and pushes each through the
device walk (``core.inference.partition_walk``), with ``inflight``
chunks in the pipeline, so that the device memory the call holds is that
of ``inflight`` chunks, not of B:

  * on a card each device has a **copy stream** and a **compute stream**.
    The host fills a pinned staging ring of ``inflight`` chunk buffers
    with ``torch.Tensor.copy_`` (PyTorch's intra-op threads); the copy
    stream uploads a chunk with ``non_blocking=True`` into a device ring
    of ``inflight`` ``(rows, P, W, 6)`` f32 buffers; the compute stream
    waits on the upload's event, walks the chunk (the hop kernel, dense
    or in survivor mode) and copies its verdict buffer into pinned host
    memory (``fetch_async``).  Buffer reuse takes the place of the JAX
    package's ``donate`` (the knob is accepted and not read): before
    chunk i + inflight is uploaded into ring slot i mod inflight the copy
    stream waits on chunk i's walk, and before the host writes a staging
    slot it waits on that slot's last upload;
  * ``collect`` waits on the fetch events of the oldest chunks, never on
    the whole device, so while the card walks chunk i the host stages
    chunk i + 1;
  * on the CPU each chunk is walked where it lies, one after another;
  * a ragged tail runs at its own size (eager PyTorch needs no static
    shape), so no padding row exists to leak into a verdict;
  * ``micro_batch=None`` reads ``core.inference.MICRO_BATCH`` for the
    engine's device (65,536 flows on a card, 4,096 on the CPU);
  * with a ``mesh`` (``launch.mesh.FlowMesh``) the micro-batch is rounded
    up to a multiple of its devices and each chunk's rows split into one
    contiguous shard a device (``distributed.sharding.flow_shards``);
    each device walks its shard on its own replica of the engine tables
    (``Engine.tables_on``) with its own streams and rings.  The walk is
    per flow, so no shard needs another.

Any walk backend streams (``fused``, and ``cuda`` on a CUDA engine);
``looped`` is refused, since it syncs the host every partition.
``impl="auto"`` / ``"tuned"`` (or ``compact="auto"``) resolve a
``repro_torch.tuning.Plan`` for the CHUNK shape (B = micro_batch,
``n_devices`` from the mesh) over the streamable backends, and the plan
lands on the result.  Each chunk adds one to
``stream_chunks_total{backend}`` and ``engine_dispatches_total{backend}``
and runs in the span ``stream/dispatch``; its collection in
``stream/fetch``; the engine's per-hop counters are recorded once a call,
from the survivor counts each chunk's walk fetched with its verdicts.

Results are int32 ``(B,)`` arrays with ``-1`` sentinels for flows that
never exit (docs/PARITY.md), equal to ``engine.run(win_pkts,
with_trace=False)`` for every B, micro-batch, backend, mesh and depth.
``run_streaming`` is the closed-batch entry point; ``stream_batches``
consumes an iterator of batches for producers that never hold the whole
workload.
"""
from __future__ import annotations

import math
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.features import PKT_NFIELDS
from repro_torch.core.inference import (
    MICRO_BATCH,
    Engine,
    EngineOptions,
    EngineResult,
    _record_walk,
    fetch_async,
    get_backend,
    partition_walk,
)
from repro_torch.distributed.sharding import flow_batch_devices, flow_shards
from repro_torch.kernels.dispatch import round_up


def microbatches(n: int, micro_batch: int) -> Iterator[tuple[int, int]]:
    """Yield ``[lo, hi)`` bounds covering ``n`` flows in fixed chunks."""
    if micro_batch <= 0:
        raise ValueError("micro_batch must be positive")
    for i in range(math.ceil(n / micro_batch)):
        yield i * micro_batch, min((i + 1) * micro_batch, n)


def _resolve_backend(engine: Engine, opt: EngineOptions, mb: int,
                     n_devices: int, win_pkts):
    """The chunk's walk backend: ``(backend, compact, compact_floor,
    plan)``, routed by ``tuning.resolve_route`` for the chunk shape over
    the streamable backends; ``looped`` is refused."""
    from repro_torch.tuning import ShapeInfo, resolve_route
    shape = ShapeInfo.from_engine(engine, win_pkts, B=mb,
                                  n_devices=n_devices)
    name, compact, floor, plan = resolve_route(
        engine, opt, win_pkts, shape=shape, backends=("fused", "cuda"),
        streaming=True)
    if name == "looped":
        raise ValueError("streaming requires a walk backend (fused or "
                         "cuda); 'looped' syncs the host every partition")
    return get_backend(name, device=engine.device), compact, floor, plan


class _Lane:
    """One device of the stream: its replica of the engine tables and, on
    a card, its copy and compute streams, its device ring of ``inflight``
    chunk-shard buffers and the event after each ring slot's last
    walk."""

    def __init__(self, engine: Engine, device: torch.device, rows: int,
                 shape: tuple, inflight: int):
        self.tables = engine.tables_on(device)
        self.device = self.tables.slot_op.device
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.copy = torch.cuda.Stream(self.device)
            self.compute = torch.cuda.Stream(self.device)
            self.ring = [torch.empty((rows,) + shape, dtype=torch.float32,
                                     device=self.device)
                         for _ in range(inflight)]
            self.walked = [None] * inflight

    def run(self, slot: int, rows: torch.Tensor, walk):
        """Upload ``rows`` (host), walk them and start their fetch:
        ``(upload event, fetch event, host view)``; no events on the
        CPU, where the walk runs in place."""
        if not self.cuda:
            return None, None, walk(rows, self.tables).numpy()
        n = rows.shape[0]
        with torch.cuda.stream(self.copy):
            if self.walked[slot] is not None:
                # ring slot reuse: the last chunk there must be walked
                self.copy.wait_event(self.walked[slot])
            x = self.ring[slot][:n]
            x.copy_(rows, non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record(self.copy)
        with torch.cuda.stream(self.compute):
            self.compute.wait_event(uploaded)
            buf = walk(x, self.tables)
            self.walked[slot] = torch.cuda.Event()
            self.walked[slot].record(self.compute)
            fetched, host = fetch_async(buf)
        return uploaded, fetched, host


def run_streaming(
    engine: Engine,
    win_pkts,                    # (B, p, W, PKT_NFIELDS) host array
    *,
    options: EngineOptions | None = None,
) -> EngineResult:
    """Streaming inference over a batch larger than one device batch.

    Equal to ``engine.run(win_pkts, with_trace=False)`` for any ``B``,
    ``micro_batch``, backend, mesh and ``inflight`` (tested, ragged tails
    included); the device memory the call holds is ``inflight`` chunks,
    not ``B``.  Knobs come from ``options`` (:class:`EngineOptions`):
    ``micro_batch``, ``inflight``, ``mesh``, ``compact``
    (True compacts each chunk's walk) and ``impl`` / ``plan`` (see the
    module docstring); a plan that decided the route lands on the
    result's ``.plan``.
    """
    opt = options if options is not None else EngineOptions()
    P = engine._check_windows(win_pkts)
    B, W = win_pkts.shape[0], win_pkts.shape[2]
    devices = (opt.mesh.devices if opt.mesh is not None
               else (engine.device,))
    nd = len(devices)
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a flow mesh of one device type, got {kinds}")
    on_card = kinds == {"cuda"}
    mb = opt.micro_batch or MICRO_BATCH["cuda" if on_card else "cpu"]
    if opt.mesh is not None:
        mb = round_up(mb, flow_batch_devices(opt.mesh))
    backend, cpt, floor, plan = _resolve_backend(engine, opt, mb, nd,
                                                 win_pkts)
    if backend.name == "cuda" and not on_card:
        raise ValueError("impl='cuda' streams on CUDA devices only")
    inflight = opt.inflight
    shape = (P, W, PKT_NFIELDS)
    rows = min(mb, B)                    # no chunk holds more
    lanes = [_Lane(engine, torch.device(d), -(-rows // nd), shape, inflight)
             for d in devices]
    staging = ([torch.empty((rows,) + shape, dtype=torch.float32,
                            pin_memory=True) for _ in range(inflight)]
               if on_card else None)
    uploads: list[list] = [[] for _ in range(inflight)]

    def walk(x, tables):
        return partition_walk(x, tables, n_subtrees=engine.tables.n_subtrees,
                              n_partitions=P, with_trace=False,
                              hop=backend.hop, compact=cpt,
                              compact_floor=floor, count_survivors=True)

    # int32 with the walk's -1 sentinels as the fill: per-batch results
    # concatenate (stream_batches) without upcasts, and an unwritten row
    # can never pass for a class-0 verdict
    labels = np.full(B, -1, dtype=np.int32)
    recircs = np.zeros(B, dtype=np.int32)
    exit_partition = np.full(B, -1, dtype=np.int32)
    survivors = np.zeros(P, dtype=np.int64)
    pending: list[list[tuple]] = []

    reg = obs.get_registry()
    chunk_counter = reg.counter(
        "stream_chunks_total", "micro-batches dispatched by run_streaming",
        labels={"backend": backend.name})
    dispatch_counter = reg.counter(
        "engine_dispatches_total", "walk calls issued",
        labels={"backend": backend.name})

    def collect(keep: int) -> None:
        while len(pending) > keep:
            parts = pending.pop(0)
            with obs.span("stream/fetch"):
                for lo, n, fetched, host in parts:
                    if fetched is not None:
                        fetched.synchronize()
                    labels[lo:lo + n] = host[:n]
                    recircs[lo:lo + n] = host[n:2 * n]
                    exit_partition[lo:lo + n] = host[2 * n:3 * n]
                    survivors[:] += host[3 * n:]

    for i, (lo, hi) in enumerate(microbatches(B, mb)):
        m, slot = hi - lo, i % inflight
        with obs.span("stream/dispatch"):
            chunk = torch.as_tensor(win_pkts[lo:hi, :P])
            if on_card:
                # the host writes a staging slot only once its last
                # upload has finished
                for ev in uploads[slot]:
                    ev.synchronize()
                stage = staging[slot][:m]
                stage.copy_(chunk)
            else:
                stage = chunk.to(torch.float32)
            parts, uploads[slot] = [], []
            for lane, (a, b) in zip(lanes, flow_shards(m, nd)):
                if a == b:
                    continue
                uploaded, fetched, host = lane.run(slot, stage[a:b], walk)
                parts.append((lo + a, b - a, fetched, host))
                if uploaded is not None:
                    uploads[slot].append(uploaded)
            pending.append(parts)
            chunk_counter.inc()
            dispatch_counter.inc()
        collect(inflight - 1)
    collect(0)
    _record_walk(survivors, B, compact=cpt and backend.ladder,
                 compact_floor=floor)
    return EngineResult(labels, recircs, exit_partition, [], plan=plan)


def stream_batches(
    engine: Engine,
    batches: Iterable,
    *,
    options: EngineOptions | None = None,
) -> Iterator[EngineResult]:
    """Open-stream form: one :class:`EngineResult` per incoming batch,
    each micro-batched on its own, so producers hand over whatever flow
    counts the capture pipeline emits."""
    for batch in batches:
        yield run_streaming(engine, batch, options=options)
