"""Device-resident flow table: per-packet streaming inference (port of
``repro.serve.flowtable``).

The paper's data plane keeps per-flow feature registers in a fixed
register pool, updates them on EVERY packet, and runs the active subtree
when a window boundary passes (paper §3.1, Fig. 4).  The batch engine
(``core.inference``) scores complete flow windows after the fact; this
module is the live analogue:

* a **hash-indexed slot table** (:class:`FlowTable`) admits flows into a
  fixed pool of ``n_buckets * bucket_size`` slots (bucketed hashing with
  linear bucket probing).  When every probe fails the flow falls back to
  a host-side spill store instead of being dropped.  Admission is one
  NumPy group-by over the tick's flow ids;
* the **fused tick engine** (``kernels.tick_step``, the default) holds
  ALL per-flow serving state on the device and runs one tick as one
  stream of launches with no host sync: per packet rank the
  fold-and-finalize kernel, then the hop of every completed window, then
  the masked drain rounds.  The verdicts come back in one fetch;
* the **legacy tick engine** (``tick_engine="legacy"``) folds one rank
  per call (the fold kernel through ``feature_update_at``) and hops one
  drain round per call, with a host fetch after each hop.  Both engines
  give identical verdicts;
* **timeout eviction** emits mid-stream verdicts for idle flows with the
  ``-1`` sentinels (labels, exit_partition), keeping the accumulated
  recirculation count.

``FlowTableServer.ingest(packets) -> StreamVerdicts`` is the entry
point; packets arrive as arrival-ordered ticks
(``flows.synthetic.make_packet_stream``).  Within a tick, packets are
processed in per-slot ranks (the r-th packet of each flow), so every
device scatter addresses each slot at most once and per-flow arrival
order, the reduction order the parity contract pins, is kept.  Rank
batches are padded to a power-of-two ladder; a dummy table row absorbs
the padding.  ``ServerStats.dispatches`` counts the same logical device
calls as the JAX server: one per admission scatter, one per tick step,
one per legacy fold or hop, one per spill run.

Execution knobs come from :class:`repro_torch.core.inference.EngineOptions`:
``impl=None`` is ``cuda`` on a CUDA engine and ``fused`` on a CPU one;
``fused`` runs the plain PyTorch versions, ``cuda`` the kernels (the
fold kernels and the range-match kernel behind the SID dispatch);
``block_b`` is the SID dispatch's block size.  Every route gives the
verdicts of ``Engine.run`` on the offline windows, bit for bit: the flow
table can only change *when* a verdict is computed, never its value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.features import PKT_IAT, PKT_NFIELDS
from repro_torch.core.inference import Engine, EngineOptions, _hop_update
from repro_torch.flows.windows import window_bounds
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tick_step as _tick
from repro_torch.kernels.dt_traverse import BLOCK_B
from repro_torch.kernels.feature_window import feature_update_at
from repro_torch.obs import MetricRegistry, exp_edges, span

#: Tick engines ``FlowTableServer`` accepts.
TICK_ENGINES = ("fused", "legacy")

#: Histogram bucket edges.  TTD is measured in STREAM time (the packet
#: arrival clock of the replayed ``PacketStream``), so two replays of
#: the same stream land every verdict in the same bucket.
TTD_EDGES = tuple(exp_edges(1e-3, 1e4, 15))
RECIRC_EDGES = (0.5, 1.5, 2.5, 4.5, 8.5, 16.5, 32.5)
WINDOW_EDGES = (1.5, 2.5, 3.5, 4.5, 6.5, 8.5, 12.5, 16.5)

_NOT_PORTED = "needs repro.tuning, which is not ported yet (ROADMAP A.9)"


# ---------------------------------------------------------------------------
# results: same field contract as core.inference.EngineResult
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StreamVerdicts:
    """Verdicts emitted by one ``ingest``/``flush`` call.

    Fields as :class:`repro_torch.core.inference.EngineResult`
    (``labels`` / ``recircs`` / ``exit_partition`` int32 with ``-1``
    sentinels) plus ``flow_id``: stream verdicts arrive in completion
    order, not batch order, so each row names its flow.
    """
    flow_id: np.ndarray          # (n,) int64 flow key per verdict
    labels: np.ndarray           # (n,) int32; -1 = never took an exit action
    recircs: np.ndarray          # (n,) int32 partition transitions
    exit_partition: np.ndarray   # (n,) int32; -1 sentinel as above

    @property
    def n_flows(self) -> int:
        return int(self.flow_id.shape[0])

    @property
    def n_unterminated(self) -> int:
        """Flows evicted or flushed without an exit action (-1 rows)."""
        return int(np.count_nonzero(np.asarray(self.exit_partition) < 0))

    @classmethod
    def empty(cls) -> "StreamVerdicts":
        return cls(np.empty(0, np.int64), np.empty(0, np.int32),
                   np.empty(0, np.int32), np.empty(0, np.int32))

    @classmethod
    def concat(cls, parts) -> "StreamVerdicts":
        """Concatenate per-tick verdicts."""
        parts = list(parts)
        if not parts:
            return cls.empty()
        return cls(
            np.concatenate([p.flow_id for p in parts]),
            np.concatenate([p.labels for p in parts]),
            np.concatenate([p.recircs for p in parts]),
            np.concatenate([p.exit_partition for p in parts]))


#: Singular alias: the per-flow row type and the batch share one shape.
StreamVerdict = StreamVerdicts


class _VerdictAccum:
    """Batched verdict builder: array chunks in, one pre-sized copy out."""

    def __init__(self):
        self._chunks: list[tuple] = []
        self.n = 0

    def add(self, fid, label, rec, exitp, first_ts: float = np.inf) -> None:
        self.add_batch(np.asarray([fid], np.int64),
                       np.asarray([label], np.int32),
                       np.asarray([rec], np.int32),
                       np.asarray([exitp], np.int32),
                       np.asarray([first_ts], np.float64))

    def add_batch(self, fids, labels, recs, exitps, first_ts=None) -> None:
        fids = np.asarray(fids, np.int64)
        if not fids.size:
            return
        if first_ts is None:
            first_ts = np.full(fids.size, np.inf, np.float64)
        self._chunks.append((fids, np.asarray(labels, np.int32),
                             np.asarray(recs, np.int32),
                             np.asarray(exitps, np.int32),
                             np.asarray(first_ts, np.float64)))
        self.n += int(fids.size)

    def first_ts(self) -> np.ndarray:
        """First-packet arrival per accumulated verdict (TTD input)."""
        if not self._chunks:
            return np.empty(0, np.float64)
        return np.concatenate([c[4] for c in self._chunks])

    def build(self) -> StreamVerdicts:
        fid = np.empty(self.n, np.int64)
        lab = np.empty(self.n, np.int32)
        rec = np.empty(self.n, np.int32)
        exp = np.empty(self.n, np.int32)
        at = 0
        for f, l, r, e, _ in self._chunks:
            fid[at:at + f.size] = f
            lab[at:at + f.size] = l
            rec[at:at + f.size] = r
            exp[at:at + f.size] = e
            at += f.size
        return StreamVerdicts(fid, lab, rec, exp)


# ---------------------------------------------------------------------------
# host hash index (bucketed, linear bucket probing, never drops)
# ---------------------------------------------------------------------------
def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finaliser: cheap, well-mixed bucket hashing."""
    x = np.asarray(x).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


class FlowTable:
    """Fixed-capacity hash index over the device slot array.

    ``capacity = n_buckets * bucket_size`` slots; a flow key hashes to a
    home bucket and takes the first free slot there, probing the next
    buckets (wrapping) on overflow.  An insert fails only when the WHOLE
    table is full; the server then spills to the host.  The batch forms
    serve one tick's UNIQUE flows per call: home buckets are hashed
    vectorized, probing stays sequential because each insert's placement
    depends on the previous one's occupancy.
    """

    def __init__(self, n_buckets: int, bucket_size: int):
        if n_buckets <= 0 or bucket_size <= 0:
            raise ValueError("n_buckets and bucket_size must be positive")
        self.n_buckets = n_buckets
        self.bucket_size = bucket_size
        self.capacity = n_buckets * bucket_size
        self.key = np.full(self.capacity, -1, np.int64)   # -1 = free slot
        self._slot_of: dict[int, int] = {}

    @property
    def resident(self) -> int:
        return len(self._slot_of)

    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        """Slot per key, ``-1`` where absent (one probe per key)."""
        keys = np.asarray(keys, np.int64)
        get = self._slot_of.get
        return np.fromiter((get(int(k), -1) for k in keys), np.int64,
                           count=keys.size)

    def _insert_at(self, key: int, b0: int) -> int:
        for probe in range(self.n_buckets):
            b = (b0 + probe) % self.n_buckets
            base = b * self.bucket_size
            free = np.nonzero(
                self.key[base:base + self.bucket_size] == -1)[0]
            if free.size:
                slot = base + int(free[0])
                self.key[slot] = key
                self._slot_of[key] = slot
                return slot
        return -1

    def insert_batch(self, keys: np.ndarray) -> np.ndarray:
        """Insert keys in order; slot per key, ``-1`` where full."""
        keys = np.asarray(keys, np.int64)
        homes = _mix64(keys) % np.uint64(self.n_buckets)
        out = np.empty(keys.size, np.int64)
        for i in range(keys.size):
            out[i] = self._insert_at(int(keys[i]), int(homes[i]))
        return out

    def free(self, slot: int) -> None:
        key = int(self.key[slot])
        del self._slot_of[key]
        self.key[slot] = -1


@dataclasses.dataclass
class _SpillFlow:
    """Host fallback for flows the hash table could not place.

    Packets are buffered and the completed flow runs through the batch
    engine's full-window walk: the same verdicts, computed late.  A
    spilled flow evicted before completion never ran a hop, so it
    reports zero recirculations with its sentinels.
    """
    length: int
    rows: list = dataclasses.field(default_factory=list)
    last_ts: float = -np.inf
    first_ts: float = np.inf


def _counter_stat(metric: str, doc: str) -> property:
    """A ServerStats field backed by a registry counter (the setter
    takes the ``stats.field += n`` idiom: counters only go up)."""
    def _get(self):
        return self.registry.counter(metric, doc).value

    def _set(self, value):
        c = self.registry.counter(metric, doc)
        c.inc(int(value) - c.value)

    return property(_get, _set, doc=doc)


class ServerStats:
    """Live integer counters for one server: a view over its
    :class:`MetricRegistry` (``serve_*`` metrics)."""

    FIELDS = ("packets", "flows_seen", "verdicts", "spilled", "evicted",
              "peak_resident", "ticks", "dispatches")

    def __init__(self, registry: MetricRegistry | None = None):
        self.registry = registry if registry is not None else MetricRegistry()

    packets = _counter_stat(
        "serve_packets_total", "packets ingested (resident + spilled)")
    flows_seen = _counter_stat(
        "serve_flows_total", "distinct flows admitted or spilled")
    verdicts = _counter_stat(
        "serve_verdicts_total", "verdicts emitted (incl. sentinels)")
    spilled = _counter_stat(
        "serve_spilled_total", "flows that fell back to the host store")
    evicted = _counter_stat(
        "serve_evicted_total", "timeout evictions (mid-stream sentinels)")
    ticks = _counter_stat(
        "serve_ticks_total", "ingest calls served")
    dispatches = _counter_stat(
        "serve_dispatches_total",
        "device calls issued (not syncs): admission, tick step, legacy "
        "fold or hop, spill run")

    @property
    def peak_resident(self):
        """Max concurrent flows (slots + spill)."""
        return int(self.registry.gauge("serve_peak_resident").value)

    @peak_resident.setter
    def peak_resident(self, value):
        self.registry.gauge(
            "serve_peak_resident",
            "max concurrent flows (slots + spill)").set(value)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"ServerStats({inner})"


# ---------------------------------------------------------------------------
# device steps of the legacy tick engine
# ---------------------------------------------------------------------------
def _pow2_cap(n: int, floor: int) -> int:
    """Smallest power of two >= n (>= floor): the rank/hop batch ladder."""
    cap = max(int(floor), 1)
    while cap < n:
        cap *= 2
    return cap


def _reset_rows(acc, seen, slots, sid_rows, dev) -> None:
    """Re-initialise the addressed rows for their (new) SID's ops, in
    place."""
    s = slots.to(torch.int64)
    acc[s], seen[s] = _ref.feature_state_init(
        dev.slot_op[sid_rows.to(torch.int64)])


def _fold_rank(acc, seen, pkt, sid_rows, slots, dev, *, cuda: bool) -> None:
    """Fold one rank (<= 1 packet per slot) into the resident state, in
    place: the fold kernel through ``feature_update_at`` (``cuda``) or
    the plain version.  Padding entries address the dummy row with an
    invalid packet; all compute identical values."""
    sid = sid_rows.to(torch.int64)
    op, fld, prd = dev.slot_op[sid], dev.slot_field[sid], dev.slot_pred[sid]
    if cuda:
        feature_update_at(acc, seen, slots, pkt, op, fld, prd)
        return
    s = slots.to(torch.int64)
    acc[s], seen[s] = _ref.feature_update_ref(pkt, op, fld, prd, acc[s],
                                              seen[s])


def _hop_rank(acc, seen, slots, sid_rows, p_rows, rec_rows, dev, *,
              n_subtrees: int, cuda: bool, block_b: int):
    """One recirculation hop for the slots whose window just completed.

    Finalize the folded registers, traverse the active subtree, and run
    the walk's own ``_hop_update`` with this batch's per-flow partition
    indices; the hopped rows are re-initialised in place for their
    post-hop SID (exited rows too: their slots are freed host-side).
    Returns ``(labels, done, sid, recircs, exit_partition)``.
    """
    s = slots.to(torch.int64)
    sid = sid_rows.to(torch.int64)
    regs = _ref.feature_finalize_ref(acc[s], seen[s], dev.slot_op[sid],
                                     dev.slot_init[sid])
    action = _tick._traverse(regs, sid_rows, dev, cuda=cuda,
                             block_b=block_b)
    neg = torch.full_like(sid_rows, -1)
    carry = (sid_rows, torch.zeros(sid_rows.shape, dtype=torch.bool,
                                   device=sid_rows.device),
             neg, rec_rows, neg)
    sid2, done, labels, rec2, exit_p = _hop_update(carry, p_rows, action,
                                                   n_subtrees)
    acc[s], seen[s] = _ref.feature_state_init(
        dev.slot_op[sid2.to(torch.int64)])
    return labels, done, sid2, rec2, exit_p


def _resolve_exec(engine: Engine, opt: EngineOptions) -> tuple[bool, int]:
    """EngineOptions -> (run the kernels?, SID-dispatch block size)."""
    impl = opt.impl or ("cuda" if engine.device.type == "cuda" else "fused")
    if impl == "cuda" and engine.device.type != "cuda":
        raise ValueError("impl='cuda' needs an engine on a CUDA device; "
                         f"this one is on {engine.device}")
    return impl == "cuda", opt.block_b or BLOCK_B


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
class FlowTableServer:
    """Per-packet streaming inference behind a resident flow table.

    ``ingest`` consumes arrival-ordered packet ticks
    (``flows.synthetic.PacketBatch``) and returns the
    :class:`StreamVerdicts` that completed during the tick; ``flush``
    evicts everything still resident (``-1`` sentinels for flows whose
    stream ended mid-window).  With ``timeout`` set, flows idle longer
    than ``timeout`` seconds of stream time are evicted at tick
    boundaries the same way.

    ``tick_engine`` is ``"fused"`` (default: one launch stream per tick,
    ``kernels.tick_step``) or ``"legacy"`` (one call per rank and per
    drain round).  ``options.impl`` picks the kernels or the plain
    versions (see the module docstring).  All choices give identical
    verdicts and stats, except the dispatch count, which is the engines'
    whole difference.

    Each flow key is served once: after its verdict (exit, flush or
    timeout) the key is retired and its late packets are dropped.  The
    retired set grows with the completed flows; run unbounded streams
    with a new server per epoch.
    """

    def __init__(self, engine: Engine, *, n_buckets: int = 64,
                 bucket_size: int = 8, timeout: float | None = None,
                 options: EngineOptions | None = None,
                 rank_floor: int = 64, tick_engine: str = "fused",
                 registry: MetricRegistry | None = None):
        if tick_engine == "auto":
            raise ValueError(f"tick_engine='auto' {_NOT_PORTED}")
        if tick_engine not in TICK_ENGINES:
            raise ValueError(f"unknown tick_engine {tick_engine!r}; "
                             f"options {TICK_ENGINES}")
        self.engine = engine
        self.options = options or EngineOptions()
        self.timeout = timeout
        self.table = FlowTable(n_buckets, bucket_size)
        self.P = engine.tables.n_partitions
        self.S = engine.tables.n_subtrees
        self._dev = engine.tables.dev
        self._rank_floor = int(rank_floor)
        self._cuda, self._block_b = _resolve_exec(engine, self.options)
        self.tick_engine = tick_engine
        # spilled flows run the batch walk on the same route
        self._spill_options = EngineOptions(
            impl="cuda" if self._cuda else "fused",
            block_b=self._block_b if self._cuda else None)
        #: (R, C) of the last fused tick's rank-major pack
        self.last_tick_shape: tuple[int, int] | None = None

        N = self.table.capacity
        self._dummy = N                       # padding scatters land here
        self.registry = registry if registry is not None else MetricRegistry()
        self.stats = ServerStats(self.registry)
        self._m_ttd = self.registry.histogram(
            "serve_ttd_seconds",
            "stream-time packet-arrival -> verdict latency (TTD)",
            edges=TTD_EDGES)
        self._m_recirc_hist = self.registry.histogram(
            "serve_recircs_per_flow",
            "recirculations accumulated per emitted verdict",
            edges=RECIRC_EDGES)
        self._m_windows = self.registry.histogram(
            "serve_windows_per_verdict",
            "partition windows visited per verdict (recircs + 1)",
            edges=WINDOW_EDGES)
        self._m_recircs = self.registry.counter(
            "serve_recircs_total",
            "recirculations summed over emitted verdicts")
        self._m_overhead = self.registry.gauge(
            "serve_recirc_overhead",
            "recirculations per ingested packet (paper bar: < 0.0005)")
        self._m_resident = self.registry.gauge(
            "serve_resident_flows",
            "concurrent flows currently held (slots + host spill)")
        self._now = -np.inf                   # stream clock: max arrival
        self._first_ts = np.full(N, np.inf, np.float64)
        self._last_ts = np.full(N, -np.inf, np.float64)
        self._recircs = np.zeros(N, np.int32)
        self._spill: dict[int, _SpillFlow] = {}
        self._retired: set[int] = set()
        if self.tick_engine == "fused":
            # everything else lives on the device (kernels.tick_step);
            # _recircs is the host mirror refreshed by each tick's fetch
            self._tstate = _tick.init_tick_state(self._dev, N + 1, self.P)
        else:
            self._acc, self._seen = _tick.blank_state(self._dev, N + 1)
            self._sid = np.zeros(N, np.int32)
            self._part = np.zeros(N, np.int32)
            self._win_lo = np.zeros(N, np.int32)
            self._win_hi = np.zeros(N, np.int32)
            self._pkts_seen = np.zeros(N, np.int32)
            self._bounds = np.zeros((N, self.P, 2), np.int32)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.engine.device)

    # -- admission ------------------------------------------------------
    @property
    def resident_flows(self) -> int:
        """Concurrent flows currently held (slots + host spill)."""
        return self.table.resident + len(self._spill)

    def _evict(self, slot: int) -> None:
        self._retired.add(int(self.table.key[slot]))
        self.table.free(slot)

    def _route_tick(self, fid: np.ndarray, flen: np.ndarray) -> np.ndarray:
        """Vectorized admission: one group-by over the tick's flow ids.

        Returns a per-packet routing code: a slot index (``>= 0``),
        ``-2`` for the host spill store, ``-1`` for retired-flow drops.
        New flows insert in first-packet order; admitted slots are
        re-initialised in one batch (``_admit_batch``).
        """
        uniq, first_idx, inv = np.unique(fid, return_index=True,
                                         return_inverse=True)
        code = self.table.lookup_batch(uniq)
        miss = np.nonzero(code < 0)[0]
        if miss.size:
            keys = uniq[miss]
            retired = np.fromiter((int(k) in self._retired for k in keys),
                                  np.bool_, count=keys.size)
            spilled = np.fromiter((int(k) in self._spill for k in keys),
                                  np.bool_, count=keys.size)
            code[miss[retired]] = -1
            code[miss[spilled]] = -2
            new = miss[~retired & ~spilled]
            if new.size:
                new = new[np.argsort(first_idx[new], kind="stable")]
                lens = flen[first_idx[new]]
                slots = self.table.insert_batch(uniq[new])
                ok = slots >= 0
                code[new] = np.where(ok, slots, -2)
                for j in np.nonzero(~ok)[0]:   # table full: host spill
                    self._spill[int(uniq[new[j]])] = _SpillFlow(
                        length=max(int(lens[j]), 1))
                self.stats.spilled += int(np.count_nonzero(~ok))
                self.stats.flows_seen += int(new.size)
                if ok.any():
                    self._admit_batch(slots[ok], lens[ok])
        return code[inv]

    def _admit_batch(self, slots: np.ndarray, lengths: np.ndarray) -> None:
        """Initialise newly admitted slots (recycled slots carry the
        previous tenant's state and SID): one device call per tick."""
        slots = np.asarray(slots, np.int64)
        lengths = np.maximum(np.asarray(lengths, np.int64), 1)
        self._last_ts[slots] = -np.inf
        self._first_ts[slots] = np.inf        # new tenant: fresh TTD clock
        if self.tick_engine == "fused":
            cap, padded = self._pad_slots(slots)
            plen = np.ones(cap, np.int32)
            plen[:slots.size] = lengths
            _tick.admit_rows(self._tstate, self._to_device(padded),
                             self._to_device(plen), self._dev)
            self.stats.dispatches += 1
            return
        # legacy: host metadata writes (vectorized) + one device reset
        P = self.P
        length = lengths.astype(np.int32)
        base = np.maximum(length // P, 1)
        w = np.arange(P, dtype=np.int32)[None, :]
        lo = np.minimum(w * base[:, None], length[:, None])
        hi = np.minimum((w + 1) * base[:, None], length[:, None])
        hi[:, P - 1] = length
        self._bounds[slots] = np.stack([lo, hi], axis=-1)
        self._sid[slots] = 0
        self._part[slots] = 0
        self._win_lo[slots] = lo[:, 0]
        self._win_hi[slots] = hi[:, 0]
        self._pkts_seen[slots] = 0
        self._recircs[slots] = 0
        cap, padded = self._pad_slots(np.sort(slots))
        _reset_rows(self._acc, self._seen, self._to_device(padded),
                    self._to_device(np.zeros(cap, np.int32)), self._dev)
        self.stats.dispatches += 1

    # -- ingest ---------------------------------------------------------
    def ingest(self, batch) -> StreamVerdicts:
        """Fold one tick of packet arrivals; return completed verdicts."""
        fid = np.asarray(batch.flow_id, np.int64)
        flen = np.asarray(batch.flow_len, np.int64)
        pk = np.asarray(batch.pkts, np.float32)
        arr = np.asarray(batch.arrival, np.float64)
        n = int(fid.shape[0])
        self.stats.packets += n
        self.stats.ticks += 1
        if n:
            self._now = max(self._now, float(arr.max()))
        out = _VerdictAccum()

        # route every packet: resident slot, spill store, or retired-drop
        with span("tick/admit"):
            slot_pk = (self._route_tick(fid, flen) if n
                       else np.empty(0, np.int64))
        self.stats.peak_resident = max(self.stats.peak_resident,
                                       self.resident_flows)

        for i in np.nonzero(slot_pk == -2)[0]:
            f = self._spill[int(fid[i])]
            f.rows.append(pk[i])
            ts = float(arr[i])
            f.last_ts = max(f.last_ts, ts)
            f.first_ts = min(f.first_ts, ts)

        res_rows = np.nonzero(slot_pk >= 0)[0]
        if res_rows.size:
            self._process_resident(slot_pk[res_rows], fid[res_rows],
                                   pk[res_rows], arr[res_rows], out)
        self._run_spilled_complete(out)
        if self.timeout is not None and n:
            self._evict_timeouts(float(arr.max()), out)
        self.stats.verdicts += out.n
        return self._finish(out)

    def flush(self) -> StreamVerdicts:
        """End of stream: evict every resident flow with sentinels."""
        out = _VerdictAccum()
        self._run_spilled_complete(out)
        live = np.nonzero(self.table.key >= 0)[0]
        if live.size:
            neg = np.full(live.size, -1, np.int32)
            out.add_batch(self.table.key[live], neg,
                          self._recircs[live], neg, self._first_ts[live])
            for slot in live:
                self._evict(int(slot))
        for key in list(self._spill):
            out.add(key, -1, 0, -1, self._spill[key].first_ts)
            del self._spill[key]
            self._retired.add(key)
        self.stats.verdicts += out.n
        return self._finish(out)

    def _finish(self, out: _VerdictAccum) -> StreamVerdicts:
        """Build the call's verdicts and fold them into the registry
        (derived from the verdicts and the stream clock only, so
        deterministic across replays and tick engines)."""
        v = out.build()
        if v.n_flows:
            rec = np.asarray(v.recircs, np.int64)
            self._m_recircs.inc(int(rec.sum()))
            self._m_recirc_hist.record_many(rec)
            self._m_windows.record_many(rec + 1)
            ttd = np.float64(self._now) - out.first_ts()
            self._m_ttd.record_many(ttd[np.isfinite(ttd)])
        pkts = self.stats.packets
        self._m_overhead.set(
            self._m_recircs.value / pkts if pkts else 0.0)
        self._m_resident.set(self.resident_flows)
        return v

    # -- device plumbing ------------------------------------------------
    def _pad_slots(self, s: np.ndarray) -> tuple[int, np.ndarray]:
        cap = _pow2_cap(s.size, self._rank_floor)
        slots = np.full(cap, self._dummy, np.int32)
        slots[:s.size] = s
        return cap, slots

    @staticmethod
    def _rank_decompose(slots: np.ndarray):
        """(order, sorted slots, group id, rank) for one tick.

        Rank r = the r-th packet of a flow within the tick: every rank
        addresses each slot at most once, and rank order keeps per-flow
        arrival order (stable argsort).
        """
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        new_grp = np.r_[True, ss[1:] != ss[:-1]]
        grp_start = np.nonzero(new_grp)[0]
        grp_id = np.cumsum(new_grp) - 1
        rank = np.arange(ss.size) - grp_start[grp_id]
        return order, ss, grp_id, rank

    def _process_resident(self, slots, fids, pkts, arr, out) -> None:
        np.minimum.at(self._first_ts, slots, arr)
        np.maximum.at(self._last_ts, slots, arr)
        if self.tick_engine == "fused":
            self._process_resident_fused(slots, pkts, out)
        else:
            self._process_resident_legacy(slots, fids, pkts, out)

    def _process_resident_fused(self, slots, pkts, out) -> None:
        """One launch stream for the whole tick, one fetch.

        The tick's packets are packed rank-major into ``(R, C)`` arrays
        (column = the flow's group index, constant across ranks; unused
        cells address the dummy row), padded on both axes to the
        power-of-two ladder.  The retired-flow guard, IAT window reset,
        fold, completion hop and empty-window drain all run in
        ``kernels.tick_step``.
        """
        with span("tick/pack"):
            order, ss, grp_id, rank = self._rank_decompose(slots)
            R = _pow2_cap(int(rank.max()) + 1, 1)
            C = _pow2_cap(int(grp_id[-1]) + 1, self._rank_floor)
            slots_rc = np.full((R, C), self._dummy, np.int32)
            pkt_rc = np.zeros((R, C, PKT_NFIELDS), np.float32)
            slots_rc[rank, grp_id] = ss
            pkt_rc[rank, grp_id] = pkts[order]
            self.last_tick_shape = (R, C)
        with span("tick/dispatch"):
            _, res = _tick.tick_step(
                self._tstate, self._to_device(slots_rc),
                self._to_device(pkt_rc), self._dev, n_subtrees=self.S,
                cuda=self._cuda, block_b=self._block_b)
            self.stats.dispatches += 1
        with span("tick/fetch"):
            # ONE device->host transfer: mask, labels, recircs, exit
            # partition and the live recirculation counts
            vm, vl, vr, ve, rec = torch.cat(res).cpu().numpy().reshape(5, -1)
        self._recircs = rec                   # host mirror (flush/timeout)
        done = np.nonzero(vm)[0]
        if done.size:
            out.add_batch(self.table.key[done], vl[done], vr[done],
                          ve[done], self._first_ts[done])
            for slot in done:
                self._evict(int(slot))

    def _process_resident_legacy(self, slots, fids, pkts, out) -> None:
        order, _, _, rank = self._rank_decompose(slots)
        for r in range(int(rank.max()) + 1):
            sel = order[rank == r]
            s = slots[sel]
            # a flow that exited earlier this tick frees its slot; any
            # later packets of it (malformed flow_len) must not fold
            # into the slot's next tenant
            alive = self.table.key[s] == fids[sel]
            sel, s = sel[alive], s[alive]
            if not s.size:
                continue
            p = pkts[sel].copy()
            # window boundary clears the dependency chain (first-packet
            # IAT = 0), matching flows.windows.window_packets
            p[self._pkts_seen[s] == self._win_lo[s], PKT_IAT] = 0.0
            self._fold(s, p)
            self._pkts_seen[s] += 1
            complete = s[self._pkts_seen[s] == self._win_hi[s]]
            if complete.size:
                self._hop_drain(complete, out)

    def _fold(self, s: np.ndarray, p: np.ndarray) -> None:
        cap, slots = self._pad_slots(s)
        sid = np.zeros(cap, np.int32)
        sid[:s.size] = self._sid[s]
        pkt = np.zeros((cap, PKT_NFIELDS), np.float32)
        pkt[:s.size] = p
        with span("tick/dispatch"):
            _fold_rank(self._acc, self._seen, self._to_device(pkt),
                       self._to_device(sid), self._to_device(slots),
                       self._dev, cuda=self._cuda)
            self.stats.dispatches += 1

    def _hop_drain(self, s: np.ndarray, out: _VerdictAccum) -> None:
        """Hop the completed slots; drain any windows that complete
        immediately after (flows shorter than P packets have empty
        trailing windows: the walk still traverses them, so we do too).
        Terminates: every drain round advances the partition."""
        while s.size:
            cap, slots = self._pad_slots(s)
            sid = np.zeros(cap, np.int32)
            sid[:s.size] = self._sid[s]
            p_rows = np.zeros(cap, np.int32)
            p_rows[:s.size] = self._part[s]
            rec = np.zeros(cap, np.int32)
            rec[:s.size] = self._recircs[s]
            with span("tick/dispatch"):
                res = _hop_rank(
                    self._acc, self._seen, self._to_device(slots),
                    self._to_device(sid), self._to_device(p_rows),
                    self._to_device(rec), self._dev, n_subtrees=self.S,
                    cuda=self._cuda, block_b=self._block_b)
                self.stats.dispatches += 1
            with span("tick/fetch"):
                labels, done, sid2, rec2, exit_p = (
                    a[:s.size] for a in torch.cat(
                        [res[0], res[1].to(torch.int32), *res[2:]]
                    ).cpu().numpy().reshape(5, -1))
            done = done.astype(bool)
            # exits emit verdicts; flows falling off the last partition
            # emit -1 sentinels; the rest advance to the next window
            fin = done | (self._part[s] == self.P - 1)
            if fin.any():
                out.add_batch(self.table.key[s[fin]],
                              np.where(done, labels, -1)[fin], rec2[fin],
                              np.where(done, exit_p, -1)[fin],
                              self._first_ts[s[fin]])
                for slot in s[fin]:
                    self._evict(int(slot))
            sa = s[~fin]
            self._sid[sa] = sid2[~fin]
            self._recircs[sa] = rec2[~fin]
            self._part[sa] += 1
            b = self._bounds[sa, self._part[sa]]
            self._win_lo[sa] = b[:, 0]
            self._win_hi[sa] = b[:, 1]
            s = sa[b[:, 0] == b[:, 1]]        # empty window: hop again

    # -- host fallbacks -------------------------------------------------
    def _run_spilled_complete(self, out: _VerdictAccum) -> None:
        """Run completed spilled flows through the batch walk."""
        done = [key for key, f in self._spill.items()
                if len(f.rows) >= f.length]
        if not done:
            return
        P = self.P
        all_bounds = {key: window_bounds(self._spill[key].length, P)
                      for key in done}
        w_max = max(1, max(hi - lo for b in all_bounds.values()
                           for lo, hi in b))
        # the flows axis is padded to the pow2 ladder, as in the JAX
        # server (batch rows are independent; the zero tail is dropped)
        cap = _pow2_cap(len(done), 1)
        wp = np.zeros((cap, P, w_max, PKT_NFIELDS), np.float32)
        for idx, key in enumerate(done):
            rows = np.stack(self._spill[key].rows)
            for w, (lo, hi) in enumerate(all_bounds[key]):
                if hi <= lo:
                    continue
                win = rows[lo:hi].copy()
                win[0, PKT_IAT] = 0.0
                wp[idx, w, :hi - lo] = win
        with span("tick/spill"):
            res = self.engine.run(wp, with_trace=False,
                                  options=self._spill_options)
            self.stats.dispatches += 1
        n = len(done)
        first = np.asarray([self._spill[k].first_ts for k in done],
                           np.float64)
        out.add_batch(np.asarray(done, np.int64), res.labels[:n],
                      res.recircs[:n], res.exit_partition[:n], first)
        for key in done:
            del self._spill[key]
            self._retired.add(key)

    def _evict_timeouts(self, now: float, out: _VerdictAccum) -> None:
        stale = np.nonzero((self.table.key >= 0)
                           & (now - self._last_ts > self.timeout))[0]
        if stale.size:
            neg = np.full(stale.size, -1, np.int32)
            out.add_batch(self.table.key[stale], neg,
                          self._recircs[stale], neg, self._first_ts[stale])
            for slot in stale:
                self._evict(int(slot))
            self.stats.evicted += int(stale.size)
        for key, f in list(self._spill.items()):
            if now - f.last_ts > self.timeout:
                out.add(key, -1, 0, -1, f.first_ts)
                del self._spill[key]
                self._retired.add(key)
                self.stats.evicted += 1
