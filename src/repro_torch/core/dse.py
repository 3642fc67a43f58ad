"""Design-space exploration via Bayesian optimisation (paper §3.2.1; a
copy of ``repro.core.dse`` whose fleet trainer and batched evaluator
are the port's ``repro_torch.fit``).

HyperMapper is not available offline, so we implement the BO loop it
provides: a Gaussian-process surrogate (RBF kernel, pure numpy
Cholesky), Expected-Improvement acquisition over randomly sampled
candidates, a feasibility surrogate (GP classifier on the resource
model's verdict) multiplied into the acquisition -- HyperMapper's
"feasibility testing" feature -- and batched proposals per iteration
(the paper runs 16 parallel evaluations).

Search space (paper: model hyperparameters):
  * number of partitions  p   in [1, max_partitions]
  * features per subtree  k   in [1, k_max]
  * per-partition depths  d_i in [1, depth_max]
Objectives: maximise F1 at a given flow target, subject to hardware
feasibility; sweeping flow targets yields the Pareto frontier
(F1 vs flows) of Fig. 6.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch import obs
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.core.recirc import ENVIRONMENTS, recirc_bandwidth
from repro_torch.core.resources import Target, TOFINO1, estimate
from repro_torch.core.tree import macro_f1


# --------------------------------------------------------------------------
# Gaussian-process surrogate (pure numpy)
# --------------------------------------------------------------------------
class GP:
    def __init__(self, length_scale: float = 0.35, noise: float = 1e-3):
        self.ls = length_scale
        self.noise = noise
        self._X: np.ndarray | None = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self._X = X
        self._ymu, self._ysd = float(y.mean()), float(y.std() + 1e-9)
        yn = (y - self._ymu) / self._ysd
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, yn))
        return self

    def predict(self, Xq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xq, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu * self._ysd + self._ymu, np.sqrt(var) * self._ysd


def expected_improvement(mu: np.ndarray, sd: np.ndarray, best: float) -> np.ndarray:
    z = (mu - best) / sd
    # standard normal pdf/cdf without scipy
    pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
    cdf = 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))
    return (mu - best) * cdf + sd * pdf


def _erf(x: np.ndarray) -> np.ndarray:
    # Abramowitz & Stegun 7.1.26
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


# --------------------------------------------------------------------------
# SpliDT configuration space
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Config:
    k: int
    partition_sizes: tuple[int, ...]

    @property
    def n_partitions(self) -> int:
        return len(self.partition_sizes)

    @property
    def depth(self) -> int:
        return int(sum(self.partition_sizes))


@dataclasses.dataclass
class Evaluation:
    config: Config
    f1: float
    feasible: bool
    flow_capacity: int
    tcam_entries: int
    register_bits: int
    recirc_mbps: float
    n_subtrees: int
    unique_features: int


@dataclasses.dataclass
class SearchSpace:
    max_partitions: int = 6
    k_max: int = 6
    depth_max: int = 10

    @property
    def dim(self) -> int:
        return 2 + self.max_partitions

    def sample(self, rng: np.random.Generator) -> Config:
        p = int(rng.integers(1, self.max_partitions + 1))
        k = int(rng.integers(1, self.k_max + 1))
        depths = tuple(int(rng.integers(1, self.depth_max + 1)) for _ in range(p))
        return Config(k, depths)

    def encode(self, c: Config) -> np.ndarray:
        x = np.zeros(self.dim)
        x[0] = c.n_partitions / self.max_partitions
        x[1] = c.k / self.k_max
        for i, d in enumerate(c.partition_sizes):
            x[2 + i] = d / self.depth_max
        return x


def make_splidt_evaluator(
    Xw_tr: np.ndarray, y_tr: np.ndarray,
    Xw_te: np.ndarray, y_te: np.ndarray,
    *,
    n_classes: int,
    flows: int,
    target: Target = TOFINO1,
    bits: int = 32,
    env_name: str = "HD",
    feature_ranges: dict[int, tuple[float, float]] | None = None,
    trainer: str = "numpy",
    win_pkts_te: np.ndarray | None = None,
    device=None,
) -> Callable[[Config], Evaluation]:
    """The paper's per-configuration pipeline: train (Algorithm 1) ->
    evaluate F1 -> generate rules -> resource/feasibility check.

    ``trainer`` selects the subtree grower passed through to
    :func:`train_partitioned_dt` (``"numpy"`` or the device fleet
    ``"torch"`` -- structurally identical models either way).  The
    serial evaluator scores F1 on ``PartitionedDT.predict``, the numpy
    oracle every engine route equals bit for bit.

    ``win_pkts_te``: optional window-*packet* tensor for the test split
    (``flows.windows.window_packets`` over the same window count as
    ``Xw_te``).  When given, the returned evaluator grows an
    ``evaluate_batch`` attribute that scores a whole candidate batch
    through the engine's walk in one call
    (``repro_torch.fit.batched.fleet_predict``: the hop kernel on the
    card); :func:`bayes_search` picks it up automatically.  Labels are
    bit-identical to ``PartitionedDT.predict`` (docs/PARITY.md), so
    serial and batched evaluation produce the same ``Evaluation``s.

    ``device`` (``None`` = the card; raises without one) is read by the
    ``"torch"`` trainer and the batched evaluator only.
    """
    if trainer not in ("numpy", "torch"):
        raise ValueError(f"unknown trainer {trainer!r}; options: numpy, "
                         "torch")
    env = ENVIRONMENTS[env_name]

    def _train(cfg: Config, max_dep):
        if cfg.n_partitions > Xw_tr.shape[1]:
            raise ValueError("config needs more windows than the dataset has")
        return train_partitioned_dt(
            Xw_tr[:, :cfg.n_partitions], y_tr,
            partition_sizes=list(cfg.partition_sizes), k=cfg.k,
            n_classes=n_classes, max_dep_depth=max_dep, trainer=trainer,
            device=device)

    def _finish(pdt, pred, recircs):
        f1 = macro_f1(y_te, pred, n_classes)
        bw = recirc_bandwidth(recircs, flows, env)
        rep = estimate(pdt, target=target, bits=bits, flows=flows,
                       recirc_mbps=bw.mean_mbps,
                       feature_ranges=feature_ranges)
        return pdt, f1, bw, rep

    def _evaluation(cfg, pdt, f1, bw, rep) -> Evaluation:
        return Evaluation(
            config=cfg, f1=f1, feasible=rep.feasible,
            flow_capacity=rep.flow_capacity, tcam_entries=rep.tcam_entries,
            register_bits=rep.register_bits_per_flow,
            recirc_mbps=bw.mean_mbps, n_subtrees=len(pdt.subtrees),
            unique_features=len(pdt.unique_features()),
        )

    def evaluate(cfg: Config) -> Evaluation:
        def attempt(max_dep):
            pdt = _train(cfg, max_dep)
            pred, recircs, _ = pdt.predict(Xw_te[:, :cfg.n_partitions],
                                           return_trace=True)
            return _finish(pdt, pred, recircs)

        pdt, f1, bw, rep = attempt(None)
        if not rep.feasible and pdt.dep_depth() > 0:
            # at high flow targets dependency registers bind: retrain on
            # dependency-free features (paper: registers vs k trade-off)
            pdt2, f12, bw2, rep2 = attempt(0)
            if rep2.feasible:
                pdt, f1, bw, rep = pdt2, f12, bw2, rep2
        return _evaluation(cfg, pdt, f1, bw, rep)

    if win_pkts_te is not None:

        def _attempt_batch(cfgs: list[Config], max_deps: list):
            """Train each config, then score ALL of them in one fleet
            walk."""
            from repro_torch.fit.batched import fleet_predict
            pdts = [_train(c, d) for c, d in zip(cfgs, max_deps)]
            P = max(p.n_partitions for p in pdts)
            labels, recircs, _ = fleet_predict(pdts, win_pkts_te[:, :P],
                                               device=device)
            return [_finish(p, labels[i], recircs[i])
                    for i, p in enumerate(pdts)]

        def evaluate_batch(cfgs: list[Config]) -> list[Evaluation]:
            if not cfgs:
                return []
            results = _attempt_batch(cfgs, [None] * len(cfgs))
            # feasibility fallback, batched the same way: retrain the
            # dependency-bound failures on dependency-free features
            redo = [i for i, (pdt, _, _, rep) in enumerate(results)
                    if not rep.feasible and pdt.dep_depth() > 0]
            if redo:
                retried = _attempt_batch([cfgs[i] for i in redo],
                                         [0] * len(redo))
                for i, res2 in zip(redo, retried):
                    if res2[3].feasible:
                        results[i] = res2
            return [_evaluation(c, *res) for c, res in zip(cfgs, results)]

        evaluate.evaluate_batch = evaluate_batch

    return evaluate


@dataclasses.dataclass
class BOResult:
    history: list[Evaluation]
    best: Evaluation | None
    iterations_to_best: int

    def pareto(self) -> list[Evaluation]:
        """Non-dominated (F1, flow_capacity) among feasible evals."""
        feas = [e for e in self.history if e.feasible]
        out = []
        for e in feas:
            if not any(o.f1 >= e.f1 and o.flow_capacity >= e.flow_capacity
                       and (o.f1 > e.f1 or o.flow_capacity > e.flow_capacity)
                       for o in feas):
                out.append(e)
        return sorted(out, key=lambda e: -e.f1)


def bayes_search(
    evaluate: Callable[[Config], Evaluation],
    space: SearchSpace,
    *,
    n_iterations: int = 30,
    batch: int = 4,
    n_init: int = 8,
    n_candidates: int = 256,
    seed: int = 0,
    evaluate_batch: Callable[[list[Config]], list[Evaluation]] | None = None,
) -> BOResult:
    """BO loop: GP surrogate on F1, GP feasibility model, EI acquisition.

    Each iteration proposes exactly ``batch`` *unseen* configs: the
    acquisition ranking is walked past the top-``batch`` entries to
    replace duplicates, topping up with fresh random samples if the
    whole candidate pool is exhausted (historically an iteration could
    silently evaluate fewer than ``batch`` -- or zero -- candidates
    when sampling collided with ``seen``).

    ``evaluate_batch`` (or an ``evaluate_batch`` attribute on
    ``evaluate``, as produced by :func:`make_splidt_evaluator` with
    ``win_pkts_te=``) scores each proposal batch in one call -- the
    paper's 16 parallel evaluations -- instead of looping
    ``evaluate`` per candidate.  History order (and therefore the GP
    state, the RNG stream, and ``BOResult``) is identical either way.
    """
    rng = np.random.default_rng(seed)
    history: list[Evaluation] = []
    seen: set[Config] = set()
    if evaluate_batch is None:
        evaluate_batch = getattr(evaluate, "evaluate_batch", None)

    def pick_fresh(ranked: list[Config], want: int) -> list[Config]:
        """First ``want`` unseen configs off the ranking; top up with
        random draws (bounded) when the ranking runs dry."""
        picked: list[Config] = []
        for c in ranked:
            if c in seen or c in picked:
                continue
            picked.append(c)
            if len(picked) == want:
                return picked
        for _ in range(50 * max(want, 1)):
            if len(picked) == want:
                break
            c = space.sample(rng)
            if c not in seen and c not in picked:
                picked.append(c)
        return picked

    def run_batch(cfgs: list[Config]):
        seen.update(cfgs)
        reg_obs = obs.get_registry()
        t0 = time.perf_counter() if obs.enabled() else 0.0
        with obs.span("dse/round"):
            if evaluate_batch is not None:
                fresh = evaluate_batch(cfgs)
            else:
                fresh = [evaluate(c) for c in cfgs]
        history.extend(fresh)
        reg_obs.counter("dse_evals_total",
                        "candidate configs evaluated").inc(len(fresh))
        reg_obs.counter(
            "dse_feasible_total", "evaluations meeting resource bounds",
        ).inc(sum(1 for e in fresh if e.feasible))
        if obs.enabled() and fresh:
            dt = time.perf_counter() - t0
            reg_obs.histogram(
                "dse_round_seconds", "wall-clock per BO candidate round",
                edges=obs.exp_edges(1e-3, 1e3, 13)).record(dt)
            if dt > 0:
                reg_obs.gauge(
                    "dse_candidates_per_s",
                    "throughput of the latest candidate round",
                ).set(len(fresh) / dt)

    run_batch(pick_fresh([space.sample(rng) for _ in range(n_init)], n_init))

    for _ in range(n_iterations):
        X = np.stack([space.encode(e.config) for e in history])
        y = np.asarray([e.f1 if e.feasible else 0.0 for e in history])
        feas = np.asarray([1.0 if e.feasible else 0.0 for e in history])
        gp_f1 = GP().fit(X, y)
        gp_feas = GP(length_scale=0.5).fit(X, feas)
        best = float(y.max(initial=0.0))

        cands = [space.sample(rng) for _ in range(n_candidates)]
        Xc = np.stack([space.encode(c) for c in cands])
        mu, sd = gp_f1.predict(Xc)
        pf, _ = gp_feas.predict(Xc)
        acq = expected_improvement(mu, sd, best) * np.clip(pf, 0.05, 1.0)
        order = np.argsort(acq)[::-1]
        run_batch(pick_fresh([cands[int(i)] for i in order], batch))

    feas_hist = [e for e in history if e.feasible]
    best_eval = max(feas_hist, key=lambda e: e.f1, default=None)
    it_best = history.index(best_eval) + 1 if best_eval else len(history)
    return BOResult(history=history, best=best_eval, iterations_to_best=it_best)
