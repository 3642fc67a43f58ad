"""Synthetic labelled flow generators (a copy of ``repro.flows.synthetic``).

The paper evaluates on CIC-* security datasets (D1-D7) which are not
redistributable/offline.  We generate synthetic flow datasets with the
same *structure*: multi-class, ~41 windowed stateful features, and --
crucially for SpliDT -- **temporal signatures**: classes behave
differently in different phases of the flow, so features computed on
later windows carry information that whole-flow or first-window top-k
features miss.  Class profiles are built as a shared base + sparse
per-class, per-phase deltas, which also reproduces the paper's observed
*feature sparsity per subtree* (Table 1: ~6-7% of features per subtree).

Datasets (analogues of the paper's D1-D3):
    d1: 19 classes (CIC-IoMT-like),  d2: 4 classes,  d3: 13 classes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple

import numpy as np

from repro_torch.core.features import (
    FLAG_ACK, FLAG_FIN, FLAG_PSH, FLAG_RST, FLAG_SYN, FLAG_URG,
    PKT_DIR, PKT_FLAGS, PKT_IAT, PKT_NFIELDS, PKT_SIZE, PKT_TS, PKT_VALID,
)

N_PHASES = 3  # early / middle / late flow behaviour


@dataclasses.dataclass
class FlowDataset:
    packets: np.ndarray     # (n_flows, max_len, PKT_NFIELDS) float32, padded
    lengths: np.ndarray     # (n_flows,) int32
    labels: np.ndarray      # (n_flows,) int64
    n_classes: int
    name: str

    @property
    def n_flows(self) -> int:
        return int(self.labels.shape[0])

    def split(self, frac: float = 0.7, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.n_flows)
        cut = int(self.n_flows * frac)
        tr, te = idx[:cut], idx[cut:]
        mk = lambda i: FlowDataset(self.packets[i], self.lengths[i],
                                   self.labels[i], self.n_classes, self.name)
        return mk(tr), mk(te)


@dataclasses.dataclass
class _Phase:
    size_mu: float        # lognormal ln-mean of packet size
    size_sigma: float
    iat_scale: float      # exponential IAT scale (seconds)
    p_bwd: float          # probability a packet is backward
    p_syn: float
    p_ack: float
    p_fin: float
    p_rst: float
    p_psh: float
    p_urg: float


def _base_phase(rng: np.random.Generator) -> _Phase:
    return _Phase(
        size_mu=rng.uniform(5.0, 6.5),
        size_sigma=rng.uniform(0.3, 0.8),
        iat_scale=10 ** rng.uniform(-4.0, -1.5),
        p_bwd=rng.uniform(0.2, 0.6),
        p_syn=0.02, p_ack=0.7, p_fin=0.02, p_rst=0.01, p_psh=0.3, p_urg=0.005,
    )


_DELTA_KEYS = ["size_mu", "size_sigma", "iat_scale", "p_bwd",
               "p_syn", "p_ack", "p_fin", "p_rst", "p_psh", "p_urg"]


def _perturb(ph: _Phase, rng: np.random.Generator, n_deltas: int) -> _Phase:
    """Sparse perturbation: change only a few behaviour parameters."""
    d = dataclasses.asdict(ph)
    keys = rng.choice(_DELTA_KEYS, size=n_deltas, replace=False)
    for key in keys:
        v = d[key]
        if key == "size_mu":
            d[key] = float(np.clip(v + rng.normal(0, 0.9), 4.0, 7.3))
        elif key == "size_sigma":
            d[key] = float(np.clip(v * rng.uniform(0.4, 2.5), 0.1, 1.5))
        elif key == "iat_scale":
            d[key] = float(np.clip(v * 10 ** rng.normal(0, 0.8), 1e-5, 1.0))
        else:
            d[key] = float(np.clip(v * rng.uniform(0.2, 4.0) + rng.uniform(0, 0.1), 0.0, 0.95))
    return _Phase(**d)


_DATASETS = {"d1": (19, 0xD1), "d2": (4, 0xD2), "d3": (13, 0xD3)}


def _synth_packets(
    profiles: list[list[_Phase]],
    labels: np.ndarray,
    lengths: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """Render per-class phase profiles into a padded packet tensor.

    Consumes ``rng`` in flow-major, phase-minor order — the exact call
    sequence :func:`make_dataset` always used, so extracting this helper
    changes no existing dataset bit.
    """
    n_flows = int(labels.shape[0])
    max_l = int(lengths.max())
    pkts = np.zeros((n_flows, max_l, PKT_NFIELDS), dtype=np.float32)

    for i in range(n_flows):
        L = int(lengths[i])
        prof = profiles[int(labels[i])]
        bounds = [0, L // 3, 2 * L // 3, L]
        ts = 0.0
        row = pkts[i]
        for ph in range(N_PHASES):
            lo, hi = bounds[ph], bounds[ph + 1]
            w = hi - lo
            if w <= 0:
                continue
            p = prof[ph]
            sizes = np.clip(rng.lognormal(p.size_mu, p.size_sigma, w), 40, 1500)
            iats = rng.exponential(p.iat_scale, w)
            if lo == 0:
                iats[0] = 0.0   # first packet of the flow has no IAT
            dirs = (rng.random(w) < p.p_bwd).astype(np.float32)
            flags = (
                (rng.random(w) < p.p_syn) * FLAG_SYN
                + (rng.random(w) < p.p_ack) * FLAG_ACK
                + (rng.random(w) < p.p_fin) * FLAG_FIN
                + (rng.random(w) < p.p_rst) * FLAG_RST
                + (rng.random(w) < p.p_psh) * FLAG_PSH
                + (rng.random(w) < p.p_urg) * FLAG_URG
            ).astype(np.float32)
            tss = ts + np.cumsum(iats)
            ts = float(tss[-1])
            row[lo:hi, PKT_TS] = tss
            row[lo:hi, PKT_SIZE] = sizes
            row[lo:hi, PKT_DIR] = dirs
            row[lo:hi, PKT_FLAGS] = flags
            row[lo:hi, PKT_IAT] = iats
            row[lo:hi, PKT_VALID] = 1.0
        # first packet of a flow always SYN-ish (handshake realism)
        row[0, PKT_FLAGS] = float(int(row[0, PKT_FLAGS]) | FLAG_SYN)
    return pkts


def make_dataset(
    name: str,
    n_flows: int = 6000,
    *,
    seed: int | None = None,
    min_len: int = 12,
    max_len: int = 192,
) -> FlowDataset:
    """Generate a labelled synthetic flow dataset.

    Half of each class's identity lives in later phases: classes are
    grouped into "families" that share the early-phase profile and only
    diverge mid/late flow, which is exactly the regime where windowed
    partitioned inference has an edge over first-k-packets top-k models.
    """
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}; options {sorted(_DATASETS)}")
    n_classes, ds_seed = _DATASETS[name]
    rng = np.random.default_rng(ds_seed if seed is None else seed)

    # class profiles: families share phase-0; members diverge in phases 1-2
    n_families = max(2, n_classes // 3)
    family_phase0 = [_base_phase(rng) for _ in range(n_families)]
    profiles: list[list[_Phase]] = []
    for c in range(n_classes):
        fam = c % n_families
        p0 = _perturb(family_phase0[fam], rng, n_deltas=1)   # nearly shared
        p1 = _perturb(p0, rng, n_deltas=3)
        p2 = _perturb(p1, rng, n_deltas=3)
        profiles.append([p0, p1, p2])

    labels = rng.integers(0, n_classes, size=n_flows)
    lengths = np.clip(
        np.exp(rng.normal(np.log(40.0), 0.7, size=n_flows)).astype(np.int64),
        min_len, max_len,
    ).astype(np.int32)
    pkts = _synth_packets(profiles, labels, lengths, rng)
    return FlowDataset(pkts, lengths, labels.astype(np.int64), n_classes, name)


# ---------------------------------------------------------------------------
# exit-rate profile workloads (early-exit compaction's scenario axis)
# ---------------------------------------------------------------------------
EXIT_PROFILES = ("front", "uniform", "back")


def _separated_phase(c: int, n_classes: int) -> _Phase:
    """A strongly class-separated phase: disjoint behaviour parameters,
    so a depth-few subtree isolates the class the first time it sees
    this phase (pure leaves -> exit)."""
    t = c / max(n_classes - 1, 1)
    # separation lives ONLY in low-noise features — tightly clustered
    # sizes (µ-gap/σ > 10) and all-forward vs all-backward direction —
    # so the trained subtree's leaves come out PURE (=> exit) instead of
    # keeping stragglers that force recirculation; flag probabilities
    # stay at base-like constants to deny the tree noisy split features
    return _Phase(
        size_mu=4.3 + 2.8 * t,              # disjoint lognormal size means
        size_sigma=0.05,
        iat_scale=10 ** (-4.0 + 2.2 * t),
        p_bwd=0.0 if t < 0.5 else 1.0,
        p_syn=0.02, p_ack=0.7, p_fin=0.02, p_rst=0.01, p_psh=0.3,
        p_urg=0.005,
    )


def make_profile_dataset(
    profile: str,
    n_flows: int = 3000,
    *,
    n_classes: int = 4,
    seed: int = 0,
    min_len: int = 24,
    max_len: int = 96,
) -> FlowDataset:
    """Synthetic workload with a controlled per-partition exit-rate shape.

    The compaction speedup of the recirculation walk depends entirely on
    WHEN flows exit, so benchmarks/tests need workloads that pin that
    axis.  Each class diverges from a shared no-signal base at a chosen
    phase; a trained :class:`PartitionedDT` can only exit a flow once
    its class has diverged, so the divergence phase dictates the exit
    partition:

    ``front``    every class diverges in phase 0 -> exits front-loaded
                 at partition 0 (the paper's common case — compaction's
                 best case);
    ``uniform``  classes spread evenly over divergence phases -> exits
                 spread across partitions (the last phase always gets
                 >= 2 classes, otherwise the lone remaining class goes
                 pure-by-elimination and exits a partition early);
    ``back``     classes are indistinguishable until the final phase ->
                 nearly every flow recirculates to the last partition
                 (compaction's adversarial worst case: nothing to skip).

    Keep ``n_classes`` modest relative to the subtree depth used for
    training: a greedy depth-d subtree must isolate every diverged class
    on one branch to exit it, so too many classes per phase push exits a
    partition later than the profile intends.
    """
    if profile not in EXIT_PROFILES:
        raise ValueError(
            f"unknown profile {profile!r}; options {EXIT_PROFILES}")
    rng = np.random.default_rng(np.random.SeedSequence([0xE817, seed]))
    base = [_base_phase(rng) for _ in range(N_PHASES)]   # shared: no signal
    diverge = {
        "front": lambda c: 0,
        # even spread, extras to the LAST phase (see docstring)
        "uniform": lambda c: (N_PHASES - 1
                              - ((n_classes - 1 - c) * N_PHASES) // n_classes),
        "back": lambda c: N_PHASES - 1,
    }[profile]
    profiles = [
        [base[ph] if ph < diverge(c) else _separated_phase(c, n_classes)
         for ph in range(N_PHASES)]
        for c in range(n_classes)
    ]
    labels = rng.integers(0, n_classes, size=n_flows)
    lengths = np.clip(
        np.exp(rng.normal(np.log(48.0), 0.5, size=n_flows)).astype(np.int64),
        min_len, max_len,
    ).astype(np.int32)
    pkts = _synth_packets(profiles, labels, lengths, rng)
    return FlowDataset(pkts, lengths, labels.astype(np.int64), n_classes,
                       f"profile_{profile}")


# ---------------------------------------------------------------------------
# replayable packet-arrival streams (flow-table serving workloads)
# ---------------------------------------------------------------------------
ARRIVAL_PROFILES = ("steady", "bursty")


class PacketBatch(NamedTuple):
    """One tick's worth of interleaved packet arrivals.

    The wire-level unit the flow-table server ingests: packets from
    many flows, in global arrival order.  ``flow_len`` is the in-band
    flow length (Homa/NDP-style — the data plane parses it from the
    transport header to know the window boundaries, exactly as
    ``window_bounds`` assumes).  ``pkts`` rows keep the FLOW-RELATIVE
    fields (timestamps, IATs) the training pipeline saw; ``arrival`` is
    the global wall-clock time used only for interleaving and
    timeout/eviction.
    """
    flow_id: np.ndarray    # (n,) int64 dataset row of each packet's flow
    flow_len: np.ndarray   # (n,) int32 total packets of that flow
    pkts: np.ndarray       # (n, PKT_NFIELDS) f32 flow-relative packet rows
    arrival: np.ndarray    # (n,) f64 global arrival time, non-decreasing

    @property
    def n_packets(self) -> int:
        return int(self.flow_id.shape[0])


@dataclasses.dataclass
class PacketStream:
    """A seeded, replayable arrival-ordered packet stream over a dataset.

    Produced by :func:`make_packet_stream`; a pure function of
    ``(dataset, seed, profile)``, so any consumer (tests, benchmarks,
    the serving layer) can replay the identical interleaving.
    """
    flow_id: np.ndarray    # (n_pkts,) int64
    flow_len: np.ndarray   # (n_pkts,) int32
    pkts: np.ndarray       # (n_pkts, PKT_NFIELDS) f32
    arrival: np.ndarray    # (n_pkts,) f64 sorted ascending
    labels: np.ndarray     # (n_flows,) ground truth, indexed by flow_id
    profile: str

    @property
    def n_packets(self) -> int:
        return int(self.flow_id.shape[0])

    @property
    def n_flows(self) -> int:
        return int(self.labels.shape[0])

    def slice(self, lo: int, hi: int) -> PacketBatch:
        return PacketBatch(self.flow_id[lo:hi], self.flow_len[lo:hi],
                           self.pkts[lo:hi], self.arrival[lo:hi])

    def ticks(self, pkts_per_tick: int) -> Iterator[PacketBatch]:
        """Replay the stream in fixed-size arrival-order ticks."""
        if pkts_per_tick <= 0:
            raise ValueError("pkts_per_tick must be positive")
        for lo in range(0, self.n_packets, pkts_per_tick):
            yield self.slice(lo, min(lo + pkts_per_tick, self.n_packets))


def make_packet_stream(
    ds: FlowDataset,
    *,
    seed: int = 0,
    profile: str = "steady",
    concurrency: float = 32.0,
    burst_size: int = 16,
) -> PacketStream:
    """Interleave a dataset's flows into one arrival-ordered stream.

    Each flow keeps its internal packet timing (the flow-relative
    ``PKT_TS`` cumsum the generator produced) and is given a global
    start offset; packets are then merged by global arrival time.
    ``concurrency`` scales how many flows overlap on average (total
    flow airtime divided by the stream's span).  Profiles:

    ``steady``  flow starts are uniform over the span — resident-flow
                count hovers around ``concurrency``;
    ``bursty``  flows arrive in clusters of ~``burst_size`` (burst
                centres uniform over the span, small in-burst jitter) —
                the flow table sees spiky occupancy and the eviction
                path actually fires.

    Per-flow packet order in the stream always matches packet order in
    the dataset (ties broken flow-major), so folding the stream through
    the flow table reproduces the offline windows bit-for-bit.
    """
    if profile not in ARRIVAL_PROFILES:
        raise ValueError(
            f"unknown profile {profile!r}; options {ARRIVAL_PROFILES}")
    rng = np.random.default_rng(np.random.SeedSequence([0x57EA, seed]))
    n = ds.n_flows
    lengths = ds.lengths.astype(np.int64)
    durations = ds.packets[np.arange(n), lengths - 1, PKT_TS].astype(np.float64)
    span = max(float(durations.sum()) / max(concurrency, 1e-9), 1e-9)
    if profile == "steady":
        starts = rng.uniform(0.0, span, size=n)
    else:
        n_bursts = max(1, n // max(burst_size, 1))
        centres = rng.uniform(0.0, span, size=n_bursts)
        starts = (centres[rng.integers(0, n_bursts, size=n)]
                  + rng.exponential(span / (8.0 * n_bursts), size=n))

    total = int(lengths.sum())
    flow_id = np.repeat(np.arange(n, dtype=np.int64), lengths)
    flow_len = np.repeat(lengths.astype(np.int32), lengths)
    pkts = np.concatenate(
        [ds.packets[i, :lengths[i]] for i in range(n)], axis=0)
    local_ts = pkts[:, PKT_TS].astype(np.float64)
    arrival = np.repeat(starts, lengths) + local_ts
    # stable sort: equal arrivals keep flow-major order, so a flow's
    # packets never reorder
    order = np.argsort(arrival, kind="stable")
    assert order.shape[0] == total
    return PacketStream(flow_id=flow_id[order], flow_len=flow_len[order],
                        pkts=pkts[order], arrival=arrival[order],
                        labels=ds.labels.copy(), profile=profile)
