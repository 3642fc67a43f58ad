"""Analytical cost model for the engine's execution backends (port of
``repro.tuning.costmodel``).

The fastest route of the partition walk flips with the batch size B, the
tables' shape, the exit profile and the device; this module picks it by
arithmetic.  The model is a per-hop work estimate in microseconds::

    cost(plan, shape) = fixed dispatch and sync overhead
                      + sum over hops p of the work of the B_p flows the
                        hop processes

where ``B_p`` is the full (per-device) batch for a dense walk and, for a
compacted hop, what that backend walks: the capacity-ladder rung for the
plain ``fused`` hop (``kernels.compaction.bucket_caps``), the exact
survivor count for ``looped`` (host fancy indexing) and ``cuda``.  The
backends, with their terms:

* **looped** (the JAX package's terms) -- two dispatches and one host
  sync a hop; the window rebuild ``B_p * W * k`` (``fw``) and the dense
  gather and range match ``B_p * (k*T + 2*L*k + 2*L + k*T + L*k)``
  (``tr_dense``);
* **fused** (the JAX package's terms) -- the plain PyTorch walk, one
  dispatch a batch, the same per-flow work, and ``B log2 B`` (``sort``) a
  compacted hop for the permutation;
* **cuda** -- the hop kernel (``csrc/engine_hop.cu``): one launch a hop
  (``call``), one pinned fetch a batch (``sync``), the window bytes
  ``B_p * W * 6 * 4`` it streams (``win_bytes``) and the compare work
  ``B_p * (k*T + L*k)`` of the flows it walks (``compare``); a compacted
  hop adds one ``compact_perm`` over the whole batch (one more ``call``
  and ``B`` in ``perm``), and walks the exact survivors: the kernel reads
  no ladder.  Offered only for an engine on a CUDA device.

Coefficients are fitted, not guessed: :func:`fit_coefficients` solves a
non-negative least squares over (work terms, measured us) samples, and
:func:`calibrate` collects those samples from runs of the actual engine.
:data:`DEFAULT_COEFFS` holds one row a platform, each fitted by
:func:`calibrate`; no figure of the JAX package's (CPU- or TPU-fitted)
carries over.  The model's job is routing (the argmin backend, whether
compaction pays), not prediction; the autotuner (``tuning.autotune``)
shortlists with it and then times.

    >>> shape = ShapeInfo(B=4096, S=9, k=4, P=3, W=24, T=16, L=16)
    >>> choose_plan(shape).backend in ("looped", "fused")
    True
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.features import PKT_NFIELDS
from repro_torch.kernels.compaction import COMPACT_FLOOR, bucket_caps

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.inference import Engine

BACKENDS = ("looped", "fused", "cuda")

#: Compaction-ladder floors the tuner sweeps for a compacted ``fused``
#: plan; ``looped`` and ``cuda`` compact exactly and read no ladder.
COMPACT_FLOOR_CANDIDATES = (64, 128, 256)


def platform_of(device: "str | torch.device") -> str:
    """The coefficient row a device reads: ``"cuda"`` or ``"cpu"``."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


@dataclasses.dataclass(frozen=True)
class ShapeInfo:
    """Everything the cost model needs to know about one workload.

    B          flows per batch (per *chunk* for streaming)
    S          subtrees across all partitions (tables are SID-keyed)
    k          feature registers per flow
    P          partitions (recirculation hops)
    W          packets per window
    T          max thresholds per register slot (padded table width)
    L          max leaves per subtree (padded table height)
    n_devices  devices the batch splits over (1 = single)
    survivors  optional per-hop active-flow fractions, ``survivors[p]``
               in (0, 1] = fraction of B still undecided entering hop p
               (``survivors[0]`` is 1.0).  None = assume no early exits
               (compaction is then pure overhead).
    """
    B: int
    S: int
    k: int
    P: int
    W: int
    T: int
    L: int
    n_devices: int = 1
    survivors: tuple[float, ...] | None = None

    def __post_init__(self):
        for f in ("B", "S", "k", "P", "W", "T", "L", "n_devices"):
            v = getattr(self, f)
            if v < (0 if f == "B" else 1):
                bound = "non-negative" if f == "B" else "positive"
                raise ValueError(f"{f} must be {bound}, got {v}")
        if self.survivors is not None and len(self.survivors) != self.P:
            raise ValueError(
                f"survivors must have one entry per hop "
                f"({self.P}), got {len(self.survivors)}")

    @classmethod
    def from_engine(cls, engine: "Engine", win_pkts=None, *,
                    B: int | None = None, W: int | None = None,
                    n_devices: int = 1,
                    survivors: Sequence[float] | None = None) -> "ShapeInfo":
        """Read (S, k, P, T, L) off an engine's tables.

        ``B``/``W`` come from ``win_pkts`` (B, P, W, F) when given
        (explicit ``B``/``W`` override); without windows both must be
        passed: the tables do not record the window width.
        """
        if win_pkts is not None:
            B = win_pkts.shape[0] if B is None else B
            W = int(win_pkts.shape[2]) if W is None else W
        elif B is None or W is None:
            raise ValueError("need win_pkts, or explicit B and W")
        S, k, T = engine.tables.dev.thresholds.shape
        return cls(B=int(B), S=int(S), k=int(k),
                   P=int(engine.tables.n_partitions), W=int(W), T=int(T),
                   L=int(engine.tables.dev.leaf_lo.shape[1]),
                   n_devices=int(n_devices),
                   survivors=None if survivors is None else tuple(survivors))

    def key(self) -> str:
        """Stable cache-key fragment (survivors excluded: the tuner keys
        on the static shape, not the data-dependent exit pattern)."""
        return (f"B{self.B}-S{self.S}-k{self.k}-P{self.P}-W{self.W}"
                f"-T{self.T}-L{self.L}-d{self.n_devices}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One resolved execution configuration.

    ``backend`` is one of :data:`BACKENDS`; ``compact``/``compact_floor``
    configure early-exit compaction (the floor shapes only the plain
    ``fused`` hop's ladder).  ``source`` records who decided
    ("costmodel", "timed", "cache", "forced") and ``est_us`` the model's
    estimate (or the measured time for timed/cache plans).  The JAX
    package's ``block_b`` has no counterpart: no backend of the port
    groups flows into SID blocks.
    """
    backend: str
    compact: bool = False
    compact_floor: int = COMPACT_FLOOR
    source: str = "costmodel"
    est_us: float | None = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"options {BACKENDS}")

    def describe(self) -> str:
        bits = [self.backend]
        if self.compact:
            bits.append(f"compact(floor={self.compact_floor})"
                        if self.backend == "fused" else "compact")
        bits.append(f"source={self.source}")
        if self.est_us is not None:
            bits.append(f"~{self.est_us:.0f}us")
        return " ".join(bits)


# ---------------------------------------------------------------------------
# coefficients
# ---------------------------------------------------------------------------
#: Work-term names, in the order :func:`work_terms` emits them.  Each
#: coefficient is us per unit of its term.  The first five are the JAX
#: package's (its ``tr_pallas`` and ``grid`` belong to the Pallas walk,
#: which the port does not have); the last three are the hop kernel's.
TERMS = (
    "call",         # per dispatch (fused: a batch; looped: an op; cuda: a launch)
    "sync",         # per host<->device round trip
    "fw",           # feature-window rebuild, per flow*W*k element
    "tr_dense",     # dense range-match + table gather, per flow*(kT+Lk...)
    "sort",         # per flow*log2(B) of a compacted hop's permutation
    "win_bytes",    # window bytes the hop kernel streams
    "compare",      # the hop kernel's compare work, per flow*(kT+Lk)
    "perm",         # per flow of compact_perm over the whole batch
)


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """us-per-unit weights for each term in :data:`TERMS`."""
    call: float
    sync: float
    fw: float
    tr_dense: float
    sort: float
    win_bytes: float
    compare: float
    perm: float

    def vector(self) -> np.ndarray:
        return np.array([getattr(self, t) for t in TERMS], dtype=np.float64)

    @classmethod
    def from_vector(cls, v: Sequence[float]) -> "Coefficients":
        return cls(**{t: float(x) for t, x in zip(TERMS, v)})


#: One row a platform, each fitted by :func:`calibrate` (terms a row's
#: samples did not exercise keep the value they were fitted from).
#:
#: ``cpu``: ``python -m repro_torch.tuning --device cpu`` on an 8-core CPU
#: host (d2, 6,000 flows, (2, 3, 2), k = 4, W = 64; probes of 256, 1,024
#: and 4,096 flows; the plain PyTorch walk and the host loop; a relative
#: fit).  A CPU fit, no device figure; ``sort`` was not exercised (no
#: compacted probe) and stays 0, and the loop's ``call`` and ``sync`` are
#: collinear (two calls and one sync a hop), split 2:1 by the minimum norm.
#:
#: ``cuda``: ``chip_smoke.py`` phase ``tune`` on an NVIDIA H100 80GB HBM3
#: at a 700.00 W power limit (the engine's d2 model, (3, 3, 3), k = 4,
#: W = 65; probes of 256, 4,096, 65,536 and 262,144 flows on windows
#: already on the card; a relative fit).  The fit pinned ``sync``,
#: ``compare`` and ``perm`` of the hop kernel to 0: its per-launch
#: ``call`` carries the fetch, and the window bytes the compare work.
DEFAULT_COEFFS: dict[str, dict[str, Coefficients]] = {
    "cpu": {
        "fused": Coefficients(call=25110.23825259915, sync=0.0,
                              fw=0.020188960460322532,
                              tr_dense=0.013879939659812372, sort=0.0,
                              win_bytes=0.0, compare=0.0, perm=0.0),
        "looped": Coefficients(call=3253.46220672128,
                               sync=1626.731103370723,
                               fw=0.020777057865961315,
                               tr_dense=0.01428422565531852, sort=0.0,
                               win_bytes=0.0, compare=0.0, perm=0.0),
    },
    "cuda": {
        "fused": Coefficients(call=16558.939134978544, sync=0.0,
                              fw=3.2379781420882986e-05,
                              tr_dense=5.679741378104845e-05, sort=0.0,
                              win_bytes=0.0, compare=0.0, perm=0.0),
        "looped": Coefficients(call=610.0556826182398,
                               sync=305.02784090462535,
                               fw=3.147577381280684e-05,
                               tr_dense=2.1254956979873726e-05, sort=0.0,
                               win_bytes=0.0, compare=0.0, perm=0.0),
        "cuda": Coefficients(call=206.56188526046876, sync=0.0, fw=0.0,
                             tr_dense=0.0, sort=0.0,
                             win_bytes=2.1043768658966492e-07,
                             compare=0.0, perm=0.0),
    },
}


def default_coefficients(backend: str, platform: str = "cpu") -> Coefficients:
    """The fitted weights of ``backend`` on ``platform``."""
    try:
        return DEFAULT_COEFFS[platform][backend]
    except KeyError:
        raise ValueError(f"no {platform} coefficients for backend "
                         f"{backend!r}") from None


# ---------------------------------------------------------------------------
# per-plan work terms
# ---------------------------------------------------------------------------
def _hop_rows(shape: ShapeInfo, plan: Plan) -> list[int]:
    """Flow slots each hop processes on ONE device.

    Dense walk: the full per-device batch every hop.  Compacted walk:
    hop 0 is dense; a later hop runs the smallest ladder rung that holds
    the survivors for the plain ``fused`` hop, and the survivor count
    itself for ``looped`` (host fancy indexing) and ``cuda`` (the hop
    kernel's survivor mode).
    """
    Bd = -(-shape.B // shape.n_devices)          # per-device batch
    surv = shape.survivors or (1.0,) * shape.P
    rows = []
    caps = bucket_caps(Bd, plan.compact_floor) if plan.compact else None
    for p in range(shape.P):
        n = Bd if p == 0 else int(math.ceil(surv[p] * Bd))
        if plan.compact and p > 0:
            rows.append(n if plan.backend != "fused"
                        else next(c for c in caps if c >= n))
        else:
            rows.append(Bd)
    return rows


def work_terms(shape: ShapeInfo, plan: Plan) -> np.ndarray:
    """Decompose one (shape, plan) into per-term work units, a vector
    aligned with :data:`TERMS`; :func:`estimate_us` is its dot product
    with a coefficient vector, and :func:`fit_coefficients` stacks them
    into a design matrix."""
    s, k = shape, shape.k
    unit = k * s.T + s.L * k                     # compare work per flow
    gather = k * s.T + 2 * s.L * k + 2 * s.L     # table rows pulled per flow
    w = dict.fromkeys(TERMS, 0.0)
    hops = _hop_rows(shape, plan)
    Bd = -(-s.B // s.n_devices)
    compacted = range(1, s.P) if plan.compact else ()

    if plan.backend == "looped":
        # two dispatches (kernel A, kernel B) and one fetch a hop; dense
        # math on the survivor rows
        w["call"] = 2.0 * s.P
        w["sync"] = float(s.P)
        for n in hops:
            w["fw"] += n * s.W * k
            w["tr_dense"] += n * (unit + gather)
        return _vec(w)

    if plan.backend == "fused":
        # ONE dispatch a batch; a compacted hop's permutation
        w["call"] = 1.0
        for _ in compacted:
            w["sort"] += Bd * math.log2(max(Bd, 2))
        for n in hops:
            w["fw"] += n * s.W * k
            w["tr_dense"] += n * (unit + gather)
        return _vec(w)

    # cuda: one hop-kernel launch a hop and one pinned fetch a batch; a
    # compacted hop adds compact_perm over the whole batch
    w["call"] = float(s.P + len(compacted))
    w["sync"] = 1.0
    for _ in compacted:
        w["perm"] += Bd
    for n in hops:
        w["win_bytes"] += n * s.W * PKT_NFIELDS * 4
        w["compare"] += n * unit
    return _vec(w)


def _vec(w: dict) -> np.ndarray:
    return np.array([w[t] for t in TERMS], dtype=np.float64)


def estimate_us(shape: ShapeInfo, plan: Plan,
                coeffs: Coefficients | None = None, *,
                platform: str = "cpu") -> float:
    """Model estimate (us per batch) for running ``shape`` under ``plan``."""
    c = coeffs or default_coefficients(plan.backend, platform)
    return float(work_terms(shape, plan) @ c.vector())


# ---------------------------------------------------------------------------
# serving tick estimate (the flow-table server's per-ingest shape)
# ---------------------------------------------------------------------------
#: Tick engines the flow-table server routes between: "fused" runs the
#: whole tick in one step (on a CUDA engine one launch of the tick kernel,
#: ``csrc/tick_step.cu``), "legacy" one fold call a rank and one hop call
#: and host sync a drain round.
TICK_ENGINES = ("fused", "legacy")


def tick_work_terms(shape: ShapeInfo, plan: Plan, *, ranks: int = 4,
                    drains: float = 1.0,
                    tick_engine: str = "fused") -> np.ndarray:
    """Per-:data:`TERMS` work units for ONE flow-table ingest tick.

    ``shape.B`` is the rank width (slots touched per tick), ``shape.W``
    should be 1 (the fold sees one packet per slot per rank), ``ranks``
    the tick's rank-chain depth and ``drains`` the expected extra hop
    rounds from empty trailing windows.  The work terms are the same for
    both tick engines; only the dispatch and sync pattern differs:

    * ``legacy`` -- one admission reset, one fold call a rank, one hop
      call and host sync a traverse round;
    * ``fused``  -- one admission scatter, ONE tick step, ONE fetch.

    The plain ``fused`` backend counts the JAX package's gather and
    range-match work; the ``cuda`` backend the kernels' packet bytes
    (one packet a slot a rank) and compare work.
    """
    if tick_engine not in TICK_ENGINES:
        raise ValueError(f"unknown tick engine {tick_engine!r}; "
                         f"options {TICK_ENGINES}")
    s, k = shape, shape.k
    unit = k * s.T + s.L * k
    gather = k * s.T + 2 * s.L * k + 2 * s.L
    B = max(int(s.B), 1)
    hops = ranks + drains                        # traverse rounds / tick
    w = dict.fromkeys(TERMS, 0.0)
    if tick_engine == "legacy":
        w["call"] = 1.0 + ranks + hops
        w["sync"] = float(hops)
    else:
        w["call"] = 2.0
        w["sync"] = 1.0
    if plan.backend == "cuda":
        w["win_bytes"] = float(ranks) * B * PKT_NFIELDS * 4
        w["compare"] = hops * B * unit
    else:
        w["fw"] = float(ranks) * B * k           # one packet per fold
        w["tr_dense"] = hops * B * (unit + gather)
    return _vec(w)


def estimate_tick_us(shape: ShapeInfo, plan: Plan, *, ranks: int = 4,
                     drains: float = 1.0, tick_engine: str = "fused",
                     coeffs: Coefficients | None = None,
                     platform: str = "cpu") -> float:
    """Model estimate (us per ingest tick) for the flow-table server."""
    c = coeffs or default_coefficients(plan.backend, platform)
    return float(tick_work_terms(shape, plan, ranks=ranks, drains=drains,
                                 tick_engine=tick_engine) @ c.vector())


def choose_tick_engine(shape: ShapeInfo, *, ranks: int = 4,
                       drains: float = 1.0, backend: str = "fused",
                       coeffs: Coefficients | None = None,
                       platform: str = "cpu") -> str:
    """Pick the fused tick against legacy per-rank serving for a table
    shape (``FlowTableServer(tick_engine="auto")``), once the walk
    backend is resolved.  Pure arithmetic; ties go to fused."""
    plan = Plan(backend=backend)
    kw = dict(ranks=ranks, drains=drains, coeffs=coeffs, platform=platform)
    fused = estimate_tick_us(shape, plan, tick_engine="fused", **kw)
    legacy = estimate_tick_us(shape, plan, tick_engine="legacy", **kw)
    return "fused" if fused <= legacy else "legacy"


def choose_tick_plan(
    shape: ShapeInfo, *, ranks: int = 4, drains: float = 1.0,
    backends: Sequence[str] = ("fused", "cuda"),
    coeffs: dict[str, Coefficients] | None = None,
    platform: str = "cpu",
) -> tuple[str, Plan]:
    """Argmin (tick_engine, walk plan) for one serving tick shape: the
    serving analogue of :func:`choose_plan`, over the walk backends the
    platform offers and both tick engines."""
    best, best_us = None, float("inf")
    for te in TICK_ENGINES:
        for plan in candidate_plans(shape, backends=backends, compact=False,
                                    platform=platform):
            c = (coeffs or {}).get(plan.backend)
            us = estimate_tick_us(shape, plan, ranks=ranks, drains=drains,
                                  tick_engine=te, coeffs=c,
                                  platform=platform)
            if us < best_us:
                best, best_us = (te, plan), us
    if best is None:
        raise ValueError(f"no tick plan among backends {tuple(backends)} "
                         f"on {platform}")
    te, plan = best
    return te, dataclasses.replace(plan, source="costmodel",
                                   est_us=round(best_us, 1))


# ---------------------------------------------------------------------------
# plan enumeration + selection
# ---------------------------------------------------------------------------
def candidate_plans(
    shape: ShapeInfo,
    *,
    backends: Sequence[str] = BACKENDS,
    compact: bool | str | None = "auto",
    compact_floors: Sequence[int] = COMPACT_FLOOR_CANDIDATES,
    platform: str = "cpu",
) -> list[Plan]:
    """Enumerate the configurations the router and the tuner choose
    between.

    ``compact``: True/False pins compaction; "auto"/None explores both.
    Compacted ``fused`` plans sweep the ladder floor; ``looped`` and
    ``cuda`` compact exactly and get a single compacted variant.
    ``backends`` restricts the search (streaming drops "looped"); ``cuda``
    is offered only on the ``cuda`` platform, an engine on a CUDA device.
    """
    compacts = (False, True) if compact in ("auto", None) else (bool(compact),)
    plans = []
    for backend in backends:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "cuda" and platform != "cuda":
            continue
        for cp in compacts:
            floors = (compact_floors if cp and backend == "fused"
                      else (COMPACT_FLOOR,))
            for fl in floors:
                plans.append(Plan(backend=backend, compact=cp,
                                  compact_floor=fl))
    return plans


def choose_plan(
    shape: ShapeInfo,
    *,
    backends: Sequence[str] = BACKENDS,
    compact: bool | str | None = False,
    coeffs: dict[str, Coefficients] | None = None,
    platform: str = "cpu",
) -> Plan:
    """The argmin-cost plan for ``shape`` (``impl="auto"``).

    Pure arithmetic, never timed, so safe on the hot path.  ``compact``
    defaults to False (the caller's explicit ``compact=`` wins); "auto"
    lets the model weigh compaction against the shape's survivor profile.
    """
    best, best_us = None, float("inf")
    for plan in candidate_plans(shape, backends=backends, compact=compact,
                                platform=platform):
        c = (coeffs or {}).get(plan.backend)
        us = estimate_us(shape, plan, c, platform=platform)
        if us < best_us:
            best, best_us = plan, us
    if best is None:
        raise ValueError(f"no plan among backends {tuple(backends)} on "
                         f"{platform}")
    return dataclasses.replace(best, source="costmodel",
                               est_us=round(best_us, 1))


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------
def fit_coefficients(
    samples: Iterable[tuple[ShapeInfo, Plan, float]],
    *,
    base: Coefficients | None = None,
    relative: bool = False,
) -> Coefficients:
    """Non-negative least-squares fit of :data:`TERMS` weights.

    ``samples`` are (shape, plan, measured_us) triples.  Terms with no
    support in the design matrix keep the ``base`` coefficient instead of
    collapsing to 0, so a partial calibration never breaks routing for
    unmeasured configurations.  Non-negativity by projected iteration:
    lstsq over the supported columns, negative solutions pinned to zero,
    the rest solved again.  ``relative`` weights each sample by
    ``1 / measured_us``, so the fit minimises relative error and a probe
    of a few hundred flows counts as much as one of 2^18 (the JAX
    package's fit, the default, is unweighted).
    """
    samples = list(samples)
    if not samples:
        raise ValueError("need at least one calibration sample")
    A = np.stack([work_terms(s, p) for s, p, _ in samples])
    y = np.array([us for _, _, us in samples], dtype=np.float64)
    if relative:
        scale = 1.0 / np.maximum(y, 1e-9)
        A, y = A * scale[:, None], y * scale
    base_v = (base or default_coefficients("fused")).vector()
    x = np.where(A.any(axis=0), 0.0, base_v)     # unsupported -> base
    free = A.any(axis=0)                         # columns with support
    for _ in range(len(TERMS)):
        idx = np.nonzero(free)[0]
        if idx.size == 0:
            break
        sol, *_ = np.linalg.lstsq(A[:, idx], y, rcond=None)
        neg = sol < 0
        x[idx] = np.where(neg, 0.0, sol)
        if not neg.any():
            break
        free[idx[neg]] = False                   # pin to 0, re-solve rest
    return Coefficients.from_vector(x)


def _probe_shape(engine: "Engine", win_pkts, n: int) -> ShapeInfo:
    """The shape of the first ``n`` flows, with their survivors entering
    each hop (from one dense run's exit partitions), so a compacted
    probe's terms count the flows it walks."""
    P = engine.tables.n_partitions
    exits = engine.run(win_pkts[:n], with_trace=False).exit_partition
    n = max(n, 1)
    surv = [float(np.count_nonzero((exits < 0) | (exits >= p))) / n
            for p in range(P)]
    return ShapeInfo.from_engine(engine, win_pkts, B=len(exits),
                                 survivors=surv)


def calibrate(
    engine: "Engine",
    win_pkts,
    *,
    probe_sizes: Sequence[int] = (256, 1024),
    repeat: int = 2,
) -> dict[str, Coefficients]:
    """Fit per-backend coefficients from timed runs of ``engine``.

    Times the ``fused`` and ``looped`` walks at each probe size (the JAX
    package times ``looped`` at the smallest only: one sample leaves its
    per-call and per-flow terms to a minimum-norm split); on a CUDA
    engine also the ``cuda`` walk at each size,
    dense and compacted (the compacted runs separate the per-launch and
    per-fetch terms and fit the permutation's).  The probes read windows
    already on the engine's device (uploaded once, outside the timed
    calls), so ``win_bytes`` weighs what the hop kernel streams from
    device memory and no term carries a host upload; each backend's fit
    is ``relative``, so the small probes that routing small batches
    depends on are not drowned by the large ones.  Returns one
    :class:`Coefficients` a backend, usable as ``choose_plan(...,
    coeffs=...)``; terms no sample exercises keep the platform default.
    """
    from repro_torch.tuning.autotune import time_plan

    platform = platform_of(engine.device)
    B = win_pkts.shape[0]
    sizes = sorted({min(s, B) for s in probe_sizes if s > 0})
    P = engine.tables.n_partitions
    win_pkts = torch.as_tensor(win_pkts[:max(sizes, default=0), :P]).to(
        device=engine.device, dtype=torch.float32)
    runs = [(b, False, n) for n in sizes for b in ("fused", "looped")]
    if platform == "cuda":
        runs += [("cuda", c, n) for n in sizes for c in (False, True)]
    shapes = {n: _probe_shape(engine, win_pkts, n) for n in sizes}
    samples: dict[str, list] = {}
    for backend, compact, n in runs:
        shape = shapes[n]
        plan = Plan(backend=backend, compact=compact)
        samples.setdefault(backend, []).append(
            (shape, plan, time_plan(engine, win_pkts[:n], plan,
                                    repeat=repeat)))
    return {b: fit_coefficients(ss, base=default_coefficients(b, platform),
                                relative=True)
            for b, ss in samples.items()}
