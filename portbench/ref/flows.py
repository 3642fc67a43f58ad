"""Frozen NumPy copy of the SpliDT flow generators, and the benchmark's
pool of distinct flows.

Packet rows have six f32 fields: timestamp, size, direction, flags,
inter-arrival time and a valid bit (``TS`` .. ``VALID``).

``make_dataset`` and ``make_profile_dataset`` reproduce the generator of
the program's ``flows/synthetic.py`` draw for draw: a configuration's
model is trained on exactly the data the program's own smoke run trains
on.  ``make_pool`` renders a traffic mix's flows from the same class
profiles (fixed by the configuration's dataset seed) in bulk: the same
distributions per class and phase, drawn in another order, so a pool of
65,536 flows takes about a second rather than a per-flow loop.  Every
seed gets the same class counts and the same multiset of lengths (the
lengths are quantiles of the generator's distribution, shuffled), so the
work of a batch does not move with the seed.
"""
from __future__ import annotations

import dataclasses
import statistics

import numpy as np

# packet fields
TS, SIZE, DIR, FLAGS, IAT, VALID = range(6)
N_FIELDS = 6
# flag bits
SYN, ACK, FIN, RST, PSH, URG = 1, 2, 4, 8, 16, 32
N_PHASES = 3


@dataclasses.dataclass
class FlowSet:
    packets: np.ndarray     # (n, max_len, N_FIELDS) f32, zero padded
    lengths: np.ndarray     # (n,) int32
    labels: np.ndarray      # (n,) int64
    n_classes: int

    @property
    def n_flows(self) -> int:
        return int(self.labels.shape[0])

    def split(self, frac: float = 0.7, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.n_flows)
        cut = int(self.n_flows * frac)
        mk = lambda i: FlowSet(self.packets[i], self.lengths[i],
                               self.labels[i], self.n_classes)
        return mk(idx[:cut]), mk(idx[cut:])


@dataclasses.dataclass
class Phase:
    size_mu: float
    size_sigma: float
    iat_scale: float
    p_bwd: float
    p_syn: float
    p_ack: float
    p_fin: float
    p_rst: float
    p_psh: float
    p_urg: float


_DELTA_KEYS = ["size_mu", "size_sigma", "iat_scale", "p_bwd",
               "p_syn", "p_ack", "p_fin", "p_rst", "p_psh", "p_urg"]
_FLAG_KEYS = (("p_syn", SYN), ("p_ack", ACK), ("p_fin", FIN),
              ("p_rst", RST), ("p_psh", PSH), ("p_urg", URG))


def _base_phase(rng: np.random.Generator) -> Phase:
    return Phase(
        size_mu=rng.uniform(5.0, 6.5),
        size_sigma=rng.uniform(0.3, 0.8),
        iat_scale=10 ** rng.uniform(-4.0, -1.5),
        p_bwd=rng.uniform(0.2, 0.6),
        p_syn=0.02, p_ack=0.7, p_fin=0.02, p_rst=0.01, p_psh=0.3, p_urg=0.005,
    )


def _perturb(ph: Phase, rng: np.random.Generator, n_deltas: int) -> Phase:
    d = dataclasses.asdict(ph)
    for key in rng.choice(_DELTA_KEYS, size=n_deltas, replace=False):
        v = d[key]
        if key == "size_mu":
            d[key] = float(np.clip(v + rng.normal(0, 0.9), 4.0, 7.3))
        elif key == "size_sigma":
            d[key] = float(np.clip(v * rng.uniform(0.4, 2.5), 0.1, 1.5))
        elif key == "iat_scale":
            d[key] = float(np.clip(v * 10 ** rng.normal(0, 0.8), 1e-5, 1.0))
        else:
            d[key] = float(np.clip(v * rng.uniform(0.2, 4.0)
                                   + rng.uniform(0, 0.1), 0.0, 0.95))
    return Phase(**d)


def _separated_phase(c: int, n_classes: int) -> Phase:
    t = c / max(n_classes - 1, 1)
    return Phase(
        size_mu=4.3 + 2.8 * t, size_sigma=0.05,
        iat_scale=10 ** (-4.0 + 2.2 * t),
        p_bwd=0.0 if t < 0.5 else 1.0,
        p_syn=0.02, p_ack=0.7, p_fin=0.02, p_rst=0.01, p_psh=0.3,
        p_urg=0.005,
    )


# --- the two dataset families, as (profiles, rng after them, lengths) ---
_DATASETS = {"d1": (19, 0xD1), "d2": (4, 0xD2), "d3": (13, 0xD3)}
_EXIT_DIVERGE = {
    "front": lambda c, n: 0,
    "uniform": lambda c, n: N_PHASES - 1 - ((n - 1 - c) * N_PHASES) // n,
    "back": lambda c, n: N_PHASES - 1,
}


def _dataset_profiles(spec: dict):
    """``(profiles, rng, length law)`` of a configuration's dataset: the
    per-class phase profiles and the generator's state right after them,
    as ``make_dataset`` / ``make_profile_dataset`` leave it."""
    if spec["kind"] == "dataset":
        n_classes, ds_seed = _DATASETS[spec["name"]]
        seed = spec.get("seed")
        rng = np.random.default_rng(ds_seed if seed is None else seed)
        n_families = max(2, n_classes // 3)
        family_phase0 = [_base_phase(rng) for _ in range(n_families)]
        profiles = []
        for c in range(n_classes):
            p0 = _perturb(family_phase0[c % n_families], rng, n_deltas=1)
            p1 = _perturb(p0, rng, n_deltas=3)
            p2 = _perturb(p1, rng, n_deltas=3)
            profiles.append([p0, p1, p2])
        law = (40.0, 0.7, spec.get("min_len", 12), spec.get("max_len", 192))
        return profiles, rng, law
    if spec["kind"] == "exit_profile":
        n_classes = spec.get("n_classes", 4)
        rng = np.random.default_rng(
            np.random.SeedSequence([0xE817, spec.get("seed", 0)]))
        base = [_base_phase(rng) for _ in range(N_PHASES)]
        diverge = _EXIT_DIVERGE[spec["profile"]]
        profiles = [[base[ph] if ph < diverge(c, n_classes)
                     else _separated_phase(c, n_classes)
                     for ph in range(N_PHASES)] for c in range(n_classes)]
        law = (48.0, 0.5, spec.get("min_len", 24), spec.get("max_len", 96))
        return profiles, rng, law
    raise ValueError(f"unknown dataset kind {spec['kind']!r}")


def _synth_packets(profiles, labels, lengths, rng) -> np.ndarray:
    """The generator's per-flow rendering, draw for draw."""
    n_flows = int(labels.shape[0])
    pkts = np.zeros((n_flows, int(lengths.max()), N_FIELDS), np.float32)
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
                iats[0] = 0.0
            dirs = (rng.random(w) < p.p_bwd).astype(np.float32)
            flags = (
                (rng.random(w) < p.p_syn) * SYN
                + (rng.random(w) < p.p_ack) * ACK
                + (rng.random(w) < p.p_fin) * FIN
                + (rng.random(w) < p.p_rst) * RST
                + (rng.random(w) < p.p_psh) * PSH
                + (rng.random(w) < p.p_urg) * URG
            ).astype(np.float32)
            tss = ts + np.cumsum(iats)
            ts = float(tss[-1])
            row[lo:hi, TS] = tss
            row[lo:hi, SIZE] = sizes
            row[lo:hi, DIR] = dirs
            row[lo:hi, FLAGS] = flags
            row[lo:hi, IAT] = iats
            row[lo:hi, VALID] = 1.0
        row[0, FLAGS] = float(int(row[0, FLAGS]) | SYN)
    return pkts


def make_training_set(spec: dict) -> FlowSet:
    """A configuration's training dataset: ``make_dataset(name, n_flows,
    seed=...)`` or ``make_profile_dataset(profile, n_flows, seed=...)`` of
    the program's generator, draw for draw."""
    profiles, rng, (mu, sigma, lo, hi) = _dataset_profiles(spec)
    n = int(spec["n_flows"])
    labels = rng.integers(0, len(profiles), size=n)
    lengths = np.clip(
        np.exp(rng.normal(np.log(mu), sigma, size=n)).astype(np.int64),
        lo, hi).astype(np.int32)
    pkts = _synth_packets(profiles, labels, lengths, rng)
    return FlowSet(pkts, lengths, labels.astype(np.int64), len(profiles))


def length_range(spec: dict) -> tuple[int, int]:
    """The shortest and longest flow the dataset's generator makes."""
    return _dataset_profiles(spec)[2][2:]


def _class_counts(weights: list[float], n: int) -> np.ndarray:
    """``n`` split by ``weights`` exactly, remainders to the largest
    fractions (ties to the lower class)."""
    w = np.asarray(weights, np.float64)
    want = w / w.sum() * n
    counts = np.floor(want).astype(np.int64)
    order = np.argsort(-(want - counts), kind="stable")
    counts[order[:n - counts.sum()]] += 1
    return counts


def _length_quantiles(n: int, mu: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """``n`` lengths at the midpoints of ``n`` equal slices of the
    generator's length law (int of a lognormal, clipped)."""
    z = statistics.NormalDist()
    q = np.asarray([z.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.exp(np.log(mu) + sigma * q).astype(np.int64),
                   lo, hi).astype(np.int32)


def make_pool(spec: dict, class_weights: list[float], n_flows: int,
              rng: np.random.Generator) -> FlowSet:
    """A traffic mix's pool: ``n_flows`` distinct flows of the dataset's
    class profiles, classes in the exact proportions ``class_weights``,
    each class's lengths the quantiles of the generator's law, the order
    and every packet drawn from ``rng``."""
    profiles, _, (mu, sigma, lo, hi) = _dataset_profiles(spec)
    C = len(profiles)
    if len(class_weights) != C:
        raise ValueError(f"{len(class_weights)} class weights for {C} "
                         "classes")
    counts = _class_counts(class_weights, n_flows)
    labels = np.repeat(np.arange(C), counts)
    lengths = np.concatenate([_length_quantiles(int(c), mu, sigma, lo, hi)
                              for c in counts if c])
    order = rng.permutation(n_flows)
    labels, lengths = labels[order], lengths[order]

    # one row a packet: flow f, position j, phase, class-and-phase params
    L = lengths.astype(np.int64)
    f = np.repeat(np.arange(n_flows), L)
    j = np.arange(f.size) - np.repeat(np.cumsum(L) - L, L)
    phase = (j >= L[f] // 3).astype(np.int64) + (j >= 2 * L[f] // 3)
    which = labels[f] * N_PHASES + phase

    def param(key):
        table = np.asarray([getattr(profiles[c][ph], key)
                            for c in range(C) for ph in range(N_PHASES)])
        return table[which]

    sizes = np.exp(param("size_mu")
                   + param("size_sigma") * rng.standard_normal(f.size))
    iats = param("iat_scale") * rng.standard_exponential(f.size)
    iats[j == 0] = 0.0
    ts = np.cumsum(iats)
    ts -= np.repeat(ts[np.cumsum(L) - L], L)     # each flow from its first
    flags = np.zeros(f.size, np.int64)
    for key, bit in _FLAG_KEYS:
        flags += (rng.random(f.size, np.float32) < param(key)) * bit
    flags[j == 0] |= SYN
    rows = np.empty((f.size, N_FIELDS), np.float32)
    rows[:, TS] = ts
    rows[:, SIZE] = np.clip(sizes, 40, 1500)
    rows[:, DIR] = rng.random(f.size, np.float32) < param("p_bwd")
    rows[:, FLAGS] = flags
    rows[:, IAT] = iats
    rows[:, VALID] = 1.0
    pkts = np.zeros((n_flows, int(L.max()), N_FIELDS), np.float32)
    pkts[f, j] = rows
    return FlowSet(pkts, lengths, labels.astype(np.int64), C)
