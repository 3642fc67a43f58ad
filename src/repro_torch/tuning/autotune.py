"""Cached empirical autotuner for the engine (``impl="tuned"``; port of
``repro.tuning.autotune``).

The cost model (``tuning.costmodel``) routes by arithmetic; this module
measures.  Given the caller's model and batch shape it

  1. shortlists candidate plans by cost-model estimate,
  2. times each shortlisted plan on a bounded probe slice of the real
     windows (one warm-up call, then ``repeat`` timed calls, median; on
     the card the device is synchronized inside the timed region),
  3. persists the winner to a JSON cache keyed by (device fingerprint,
     shape key, search restrictions), so every later ``impl="tuned"``
     call with the same shape on the same device is a dict lookup,
  4. falls back to the pure cost model when timing is not allowed
     (``allow_timing=False`` or ``SPLIDT_AUTOTUNE_NO_TIME=1``).

Cache location: the ``SPLIDT_AUTOTUNE_CACHE`` environment variable, else
``~/.cache/splidt/autotune.json``, the JAX package's names.  The
fingerprint (``torch-cuda:<card>:<count>`` or ``torch-cpu:cpu<N>``) keeps
the port's entries apart from the JAX package's in one file.

Correctness is never at stake: every backend is bit-identical
(docs/PARITY.md), so a stale or corrupt entry can only cost speed.  An
entry naming a backend the port does not have is ignored and retuned.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.compaction import COMPACT_FLOOR
from repro_torch.tuning.costmodel import (
    BACKENDS,
    Plan,
    ShapeInfo,
    candidate_plans,
    choose_plan,
    estimate_us,
    platform_of,
)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.inference import Engine

CACHE_ENV = "SPLIDT_AUTOTUNE_CACHE"
NO_TIME_ENV = "SPLIDT_AUTOTUNE_NO_TIME"
CACHE_VERSION = 1

#: Probe slice bound: candidates are timed on at most this many flows.
PROBE_FLOWS = 2048

#: How many cost-model-shortlisted candidates get timed.
SHORTLIST = 4


def cache_path() -> str:
    """The cache file (the environment's override, else ~/.cache)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "splidt",
                        "autotune.json")


@functools.lru_cache(maxsize=None)
def _fingerprint(device: torch.device) -> str:
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        fp = f"torch-cuda:{name}:{torch.cuda.device_count()}"
    else:
        fp = f"torch-cpu:cpu{os.cpu_count()}"
    return fp.replace(" ", "_")


def device_fingerprint(device: "str | torch.device" = "cpu") -> str:
    """Identity of the device a plan was timed on: the card's name and
    the visible card count, or the host's core count for the CPU."""
    return _fingerprint(torch.device(device))


def _compact_tag(compact) -> str:
    """Cache-key fragment for the caller's compaction request: a plan
    tuned under ``compact="auto"`` must not be served to a caller who
    pinned ``compact=False``, so pinned and auto requests cache apart."""
    if compact in ("auto", None):
        return "cA"
    return "c1" if compact else "c0"


def cache_key(shape: ShapeInfo, *, streaming: bool = False,
              compact="auto", backends: Sequence[str] = BACKENDS,
              device: "str | torch.device" = "cpu") -> str:
    """Cache identity: device x shape x every search restriction (a
    winner of a narrowed search may never have met the best plan)."""
    return (f"{device_fingerprint(device)}/{shape.key()}"
            f"/{_compact_tag(compact)}/b={'+'.join(sorted(backends))}"
            + ("/stream" if streaming else ""))


# ---------------------------------------------------------------------------
# cache I/O -- tolerant of missing or corrupt files (tuning must never
# break inference)
# ---------------------------------------------------------------------------
# path -> ((mtime_ns, size), entries): keeps the warm impl="tuned" path
# off the disk (stream_batches resolves a plan per incoming batch)
_load_memo: dict[str, tuple[tuple, dict]] = {}

# (cache path, cache key) -> the winning Plan of THIS process's timed
# searches: where the cache file cannot be written, later calls in the
# process are still lookups
_winner_memo: dict[tuple[str, str], Plan] = {}


def _file_stamp(path: str):
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


def load_cache(path: str | None = None) -> dict:
    path = path or cache_path()
    try:
        stamp = _file_stamp(path)
        hit = _load_memo.get(path)
        if hit is not None and hit[0] == stamp:
            return dict(hit[1])
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != CACHE_VERSION:
            return {}
        entries = data.get("entries")
        entries = entries if isinstance(entries, dict) else {}
        _load_memo[path] = (stamp, entries)
        # a copy: autotune adds to it before saving, and a failed save
        # must not leave phantom entries in the memo
        return dict(entries)
    except (OSError, ValueError):
        return {}


def save_cache(entries: dict, path: str | None = None) -> str:
    path = path or cache_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    try:
        _load_memo[path] = (_file_stamp(path), dict(entries))
    except OSError:
        pass
    return path


def _plan_to_entry(plan: Plan, us: float) -> dict:
    return {"backend": plan.backend, "compact": plan.compact,
            "compact_floor": plan.compact_floor, "us": round(us, 1)}


def _entry_to_plan(entry: dict) -> Plan | None:
    try:
        if entry["backend"] not in BACKENDS:
            return None
        return Plan(backend=entry["backend"],
                    compact=bool(entry.get("compact", False)),
                    compact_floor=int(entry.get("compact_floor",
                                                COMPACT_FLOOR)),
                    source="cache", est_us=float(entry.get("us", 0)) or None)
    except (KeyError, TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_plan(engine: "Engine", win_pkts, plan: Plan, *,
              repeat: int = 3) -> float:
    """Median us a call for running ``win_pkts`` under ``plan``.

    One untimed warm-up call (kernel builds, allocator warm-up); the
    verdicts are fetched inside the timed region, and on the card the
    device is synchronized there too: the fetch is part of the cost.
    """
    from repro_torch.core.inference import EngineOptions, backend_for_plan

    backend = backend_for_plan(plan)
    opt = EngineOptions(compact=plan.compact,
                        compact_floor=plan.compact_floor)
    cuda = engine.device.type == "cuda"

    def call():
        backend.run(engine, win_pkts, with_trace=False, options=opt)
        if cuda:
            torch.cuda.synchronize(engine.device)

    call()
    ts = []
    for _ in range(max(repeat, 1)):
        t0 = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


@functools.lru_cache(maxsize=4096)
def _choose_cached(shape: ShapeInfo, backends: tuple, compact,
                   platform: str) -> Plan:
    """Memoised :func:`choose_plan` for the ``impl="auto"`` hot path: the
    default coefficients are constants, so the argmin for a (shape,
    backends, compact, platform) never changes within a process."""
    return choose_plan(shape, backends=backends, compact=compact,
                       platform=platform)


def _timing_allowed(allow_timing: bool | None) -> bool:
    if allow_timing is not None:
        return allow_timing
    return os.environ.get(NO_TIME_ENV, "") not in ("1", "true", "yes")


def _engine_backends(engine: "Engine", backends: Sequence[str]) -> tuple:
    """``backends`` without ``cuda`` unless the engine is on a card."""
    on_card = engine.device.type == "cuda"
    return tuple(b for b in backends if b != "cuda" or on_card)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------
def autotune(
    engine: "Engine",
    win_pkts,
    *,
    shape: ShapeInfo | None = None,
    backends: Sequence[str] = BACKENDS,
    compact: bool | str | None = "auto",
    allow_timing: bool | None = None,
    cache: bool = True,
    path: str | None = None,
    force: bool = False,
    repeat: int = 3,
    probe_flows: int = PROBE_FLOWS,
    shortlist: int = SHORTLIST,
    streaming: bool = False,
) -> Plan:
    """Resolve the best plan for (engine, batch shape) on the engine's
    device.

    Resolution order: cache hit, timed search, cost model.  ``shape``
    defaults to the batch's own; pass it to tune for another deployment
    batch size than the probe windows.  ``backends`` restricts the
    candidates (``cuda`` only counts on a CUDA engine; streaming passes
    the walk backends); ``compact="auto"`` measures compaction both ways,
    True/False pins it.  ``force=True`` ignores and overwrites the cache
    entry.  The probe never runs more than ``probe_flows`` flows, and
    only the ``shortlist`` best estimates are timed.
    """
    backends = _engine_backends(engine, backends)
    platform = platform_of(engine.device)
    if shape is None:
        shape = ShapeInfo.from_engine(engine, win_pkts)
    key = cache_key(shape, streaming=streaming, compact=compact,
                    backends=backends, device=engine.device)

    reg_obs = obs.get_registry()
    mkey = (path or cache_path(), key)
    entries = load_cache(path) if cache else {}
    if cache and not force:
        hit = _entry_to_plan(entries.get(key, {}))
        if hit is None:
            hit = _winner_memo.get(mkey)
        if hit is not None and hit.backend in backends:
            reg_obs.counter("tune_cache_hits_total",
                            "autotune calls served from cache").inc()
            return hit
    reg_obs.counter("tune_cache_misses_total",
                    "autotune calls not served from cache").inc()

    if not _timing_allowed(allow_timing):
        return choose_plan(shape, backends=backends,
                           compact=False if compact == "auto" else compact,
                           platform=platform)

    # ---- timed search over the cost-model shortlist -------------------
    n = min(shape.B, probe_flows, win_pkts.shape[0])
    probe = win_pkts[:n]
    ranked = sorted(
        candidate_plans(shape, backends=backends, compact=compact,
                        platform=platform),
        key=lambda p: estimate_us(shape, p, platform=platform))
    best_plan, best_us = None, float("inf")
    for plan in ranked[:max(shortlist, 1)]:
        with obs.span("tune/probe"):
            us = time_plan(engine, probe, plan, repeat=repeat)
        reg_obs.counter("tune_probes_total", "timed probe runs",
                        labels={"backend": plan.backend}).inc()
        if obs.enabled():
            reg_obs.histogram(
                "tune_probe_us", "probe outcome (median us/call)",
                edges=obs.exp_edges(10.0, 1e7, 13),
                labels={"backend": plan.backend}).record(us)
        if us < best_us:
            best_plan, best_us = plan, us
    winner = dataclasses.replace(best_plan, source="timed",
                                 est_us=round(best_us, 1))
    if cache:
        _winner_memo[mkey] = dataclasses.replace(winner, source="cache")
        entries[key] = _plan_to_entry(winner, best_us)
        try:
            save_cache(entries, path)
        except OSError:
            pass    # an unwritable cache: the in-process memo above
                    # still routes this process; never raise out of
                    # inference over persistence
    return winner


def get_plan(
    engine: "Engine",
    win_pkts=None,
    *,
    impl: str = "auto",
    shape: ShapeInfo | None = None,
    backends: Sequence[str] = BACKENDS,
    compact: bool | str | None = False,
    streaming: bool = False,
) -> Plan:
    """The engine's entry point: resolve ``impl`` to a :class:`Plan`.

    * ``impl="auto"``  -- the cost model (never timed, no cache);
    * ``impl="tuned"`` -- :func:`autotune` (cache, timed, cost model);
      without windows to probe, the cost model;
    * a fixed backend name -- a forced plan for it, ``compact="auto"``
      still decided by the cost model.

    ``cuda`` is a candidate only for an engine on a CUDA device.
    """
    backends = _engine_backends(engine, backends)
    platform = platform_of(engine.device)
    if shape is None:
        if win_pkts is None:
            raise ValueError("need win_pkts or an explicit shape")
        shape = ShapeInfo.from_engine(engine, win_pkts)
    if impl == "tuned":
        if win_pkts is None:
            return choose_plan(shape, backends=backends,
                               compact=False if compact == "auto" else compact,
                               platform=platform)
        return autotune(engine, win_pkts, shape=shape, backends=backends,
                        compact=compact, streaming=streaming)
    if impl == "auto":
        return _choose_cached(shape, backends, compact, platform)
    if impl == "cuda" and platform != "cuda":
        raise ValueError("impl='cuda' needs an engine on a CUDA device; "
                         f"this one is on {engine.device}")
    if impl not in BACKENDS:
        raise ValueError(f"unknown impl {impl!r}; options: auto, tuned, "
                         + ", ".join(sorted(BACKENDS)))
    if impl not in backends:
        raise ValueError(f"impl {impl!r} not allowed here "
                         f"(allowed: {backends})")
    if compact == "auto":
        plan = choose_plan(shape, backends=(impl,), compact="auto",
                           platform=platform)
        return dataclasses.replace(plan, source="forced")
    plan = Plan(backend=impl, compact=bool(compact), source="forced")
    return dataclasses.replace(
        plan, est_us=round(estimate_us(shape, plan, platform=platform), 1))


def resolve_route(engine: "Engine", options, win_pkts=None, *,
                  shape: ShapeInfo | None = None,
                  backends: Sequence[str] = BACKENDS,
                  streaming: bool = False) -> tuple:
    """The routing decision of every engine entry point (``Engine.run``,
    ``run_streaming``, ``FlowTableServer``): an ``EngineOptions`` ->
    ``(backend name, compact, compact_floor, plan)``.

    A resolved ``options.plan`` wins; ``impl="auto"|"tuned"`` or
    ``compact="auto"`` resolve a plan through :func:`get_plan` for
    ``shape`` (default: the batch's own) over ``backends``; otherwise
    the named backend (``"ref"`` is ``fused``; ``None``: the engine's
    own ``impl``, and where that is ``None`` too ``cuda`` on a CUDA
    engine, ``fused`` elsewhere) with the options' own compaction, and
    no plan.  The caller checks the name against what its path can run.
    """
    default = "cuda" if engine.device.type == "cuda" else "fused"
    impl = options.impl or engine.impl
    if impl == "ref":
        impl = "fused"
    plan = options.plan
    if plan is None and (impl in ("auto", "tuned")
                         or options.compact == "auto"):
        plan = get_plan(engine, win_pkts, impl=impl or default,
                        shape=shape, backends=backends,
                        compact=options.compact, streaming=streaming)
    if plan is not None:
        return plan.backend, plan.compact, plan.compact_floor, plan
    return (impl or default, bool(options.compact),
            options.compact_floor, None)
