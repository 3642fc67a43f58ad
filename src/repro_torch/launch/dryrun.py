"""The dry run (port of ``repro.launch.dryrun``): every (architecture x
input shape) cell on the single-pod 16x16 mesh and the 2x16x16 multi-pod
mesh, counted on the ``meta`` device.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all          # every cell, subprocesses
    python -m repro_torch.launch.dryrun --all --jobs 4
    python -m repro_torch.analysis.report              # the tables

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(never in the JAX package's ``experiments/dryrun/``).

JAX lowers and compiles each cell for 256 (or 512) fake devices and reads
XLA's memory and cost analyses and the collectives of its partitioned
HLO.  The port counts its eager program on ``meta`` instead, once whole
and once sharded; a record holds, per cell:

* ``analytic_memory``: JAX's budget on the resolved specs, its bytes
  equal to JAX's, ``fits`` judged against the H100's memory;
* ``memory_analysis``: argument and output bytes per chip from the
  shardings (outputs placed as the inputs they replace, new arrays by
  ``batch_spec``); XLA's temp and code bytes have no counterpart and are
  ``null``;
* ``counts``, in place of ``cost_analysis``: the step (train: loss,
  backward and AdamW; prefill; or decode over ``abstract_cache`` filled
  to its last position) run once under ``analysis.roofline.OpCounter`` on
  ``meta`` at full width, full depth and the shape's global batch; a
  train step's counts include the forward its remat recomputes in the
  backward, as JAX's compiled HLO does (the FSDP-2D train cells of
  ``opt`` run without remat, as in JAX);
  ``t_trace_s`` in place of the lower and compile times.  A serving step
  is counted on its second call: the first casts the bf16 weight copies,
  as a server's first step does;
* ``collectives`` (every ``ok`` cell, both meshes, as in JAX):
  ``{counts, bytes_by_kind}`` per chip by JAX's five kinds, from
  :func:`trace_sharded`: the step run as a sharded program over a fake
  process group of the mesh's size (``group.fake_group``), parameters,
  optimizer state, batch and cache DTensors with ``meta`` local shards
  placed by the rules' specs, the models' ``layers.shard`` constraints
  at JAX's sites, and every collective DTensor emits counted by
  ``analysis.roofline.CollectiveCounter``; ``t_sharded_trace_s`` its
  seconds.  A cell the sharded trace cannot run records
  ``collectives: {"error": ...}`` naming the cell and the op;
* ``roofline`` (single-pod, as in JAX): two depth variants give the
  affine line of the op counts and of the collective bytes, checked
  against the full-depth counts (``affine_rel_err``); the compute and
  memory terms are the global counts over the chips (an ideal
  partition), the collective term the sharded trace's bytes per chip
  over ``LINK_BW``; the bottleneck is the largest of the three.

A host read in a step fails on ``meta`` and the cell's record says
``status: error`` with the reason.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable

import torch

from repro_torch.analysis import memory as memory_lib
from repro_torch.analysis import roofline as roof
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ArchConfig, SHAPES, ShapeCfg, shape_supported
from repro_torch.distributed import pspec as pspec_lib
from repro_torch.device import on_meta
from repro_torch.distributed import group
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_shape_dict
from repro_torch.models import layers as L
from repro_torch.models import model_zoo
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """One cell's step on ``meta``: ``build()`` makes the model,
    ``inputs(model)`` fresh arguments for ``step`` (outside the count),
    and the abstract trees and specs the budget reads."""
    step: Callable
    build: Callable
    inputs: Callable
    defs: dict
    rules: dict | None
    param_dtype: torch.dtype | None
    arg_bytes: int
    out_bytes: Callable          # step's output -> bytes per chip
    cache_abs: dict | None
    cache_specs: dict | None


def _layout(cfg: ArchConfig, shape: ShapeCfg, layout: str):
    """(rules, param dtype, batch layout) of a cell under ``layout``."""
    if layout == "opt":
        if shape.kind == "train" and cfg.moe is None:
            return pspec_lib.FSDP2D_RULES, None, "fsdp2d"
        if shape.kind in ("prefill", "decode"):
            return pspec_lib.SERVE_RULES, torch.bfloat16, "tp"
    return None, None, "tp"


def _set_switches(layout: str, batch_layout: str) -> None:
    L.set_layout(batch_layout)
    if layout == "base":
        # paper-faithful baseline: naive (probs-materialising) attention,
        # scatter MoE dispatch, full-cache window masking
        L.set_blockwise_min(1 << 30)
        L.set_window_slice(False)
        moe_lib.set_einsum_decode(False)
    if layout == "opt":
        L.set_blockwise_min(2048)
        if batch_layout == "fsdp2d":
            transformer.set_remat(False)   # ample per-chip headroom


def _restore_switches() -> None:
    L.set_layout("tp")
    L.set_blockwise_min(2048)
    L.set_window_slice(True)
    moe_lib.set_einsum_decode(True)
    transformer.set_remat(True)


def _cache(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh, layout: str):
    """The abstract decode cache of a cell and its specs."""
    cache_abs = model_zoo.abstract_cache(cfg, shape)
    return cache_abs, pspec_lib.map_structure(
        lambda x: sharding.cache_spec(mesh, tuple(x.shape), cfg,
                                      opt=layout == "opt"), cache_abs)


def build_cell(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
               layout: str = "base", device: str = "meta",
               dmesh=None) -> Cell:
    """layout:
      base -- paper-faithful: TP+FSDP sharding, naive attention, scatter
              MoE dispatch, full-cache window masking
      opt  -- FSDP-2D train layout (dense archs, no remat), resident
              bf16 weights + EP-2D experts for serving, blockwise
              attention, einsum MoE decode dispatch, window-local cache
              slicing

    Sets the model switches of ``layout``; the caller restores them
    (:func:`trace_cell` does, in a ``finally``).  The port's models hold
    f32 parameters; serving reads their cached bf16 copies.  ``device``
    ``"cpu"`` makes the same step on real tensors (seeded parameters,
    ``concrete_batch``), which the tests count beside ``meta``.  With
    ``dmesh``, a runtime mesh of ``mesh``'s axes (``group.fake_group``),
    the step is the sharded program: parameters (so the optimizer
    state), batch and cache are DTensors placed by the rules' specs
    (``sharding.place_abstract``), on ``meta`` or, with ``device``
    ``"cpu"`` on a mesh of one rank, on the same values as the plain
    step's."""
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    rules, param_dtype, blayout = _layout(cfg, shape, layout)
    _set_switches(layout, blayout)
    zoo = model_zoo.get_model(cfg)
    defs = zoo.param_defs(cfg)
    msizes = mesh_shape_dict(mesh)
    pspecs = pspec_lib.resolve_specs(defs, msizes, rules)
    params_abs = pspec_lib.abstract_params(defs, dtype=param_dtype)
    batch_abs = model_zoo.input_specs(cfg, shape)
    batch_specs = pspec_lib.map_structure(
        lambda x: sharding.batch_spec(mesh, tuple(x.shape), blayout),
        batch_abs)
    nbytes = lambda tree, specs: memory_lib._sharded_bytes(tree, specs,
                                                           msizes)
    new_bytes = lambda t: nbytes(t, sharding.batch_spec(
        mesh, tuple(t.shape), blayout))
    if device == "meta":
        batch = batch_abs
        params = lambda: pspec_lib.abstract_params(defs)
    else:
        batch = model_zoo.concrete_batch(cfg, shape, device=device)
        params = lambda: pspec_lib.init_params(
            defs, torch.Generator(device).manual_seed(0), device)
    build = lambda: zoo.build(cfg, params())
    place = lambda tree, spec_fn: tree
    if dmesh is not None:
        place = lambda tree, spec_fn: sharding.place_abstract(
            tree, pspec_lib.map_structure(
                lambda x: sharding.NamedSharding(dmesh, spec_fn(x))
                if isinstance(x, torch.Tensor) else None, tree))
        drules = rules
        if blayout == "fsdp2d":        # the flattened mesh (_fake_mesh)
            drules = {k: "data" if v == ("data", "model") else v
                      for k, v in rules.items()}
        named = sharding.train_state_shardings(cfg, dmesh, defs,
                                               drules).params
        batch = place(batch, lambda x: sharding.batch_spec(
            dmesh, tuple(x.shape), blayout))
        build = lambda: zoo.build(cfg, sharding.place_abstract(params(),
                                                               named))

    if shape.kind == "train":
        opt = AdamW(lr=1e-3)
        f32 = pspec_lib.abstract_params(defs, dtype=torch.float32)
        scalar = torch.empty((), dtype=torch.int32, device="meta")
        state_bytes = (nbytes(scalar, ()) + nbytes(params_abs, pspecs)
                       + 2 * nbytes(f32, pspecs))
        return Cell(
            make_train_step(cfg, opt), build,
            lambda model: (opt.init(model), batch, None), defs, rules,
            param_dtype, state_bytes + nbytes(batch_abs, batch_specs),
            lambda out: state_bytes + nbytes(out[1]["loss"], ()), None,
            None)

    cache_abs, cache_specs = _cache(cfg, shape, mesh, layout)
    cache_bytes = nbytes(cache_abs, cache_specs)
    p_bytes = nbytes(params_abs, pspecs)

    def fresh_cache(length: int):
        with on_meta() if device == "meta" else contextlib.nullcontext():
            c = zoo.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device=device)
        return place(model_zoo.host_lengths(c, length),
                     lambda x: sharding.cache_spec(
                         dmesh, tuple(x.shape), cfg, opt=layout == "opt"))

    if shape.kind == "prefill":
        return Cell(
            make_prefill_step(cfg), build,
            lambda model: (model, batch, fresh_cache(0)), defs, rules,
            param_dtype,
            p_bytes + nbytes(batch_abs, batch_specs) + cache_bytes,
            lambda out: cache_bytes + new_bytes(out[0]), cache_abs,
            cache_specs)

    return Cell(
        make_decode_step(cfg), build,
        lambda model: (model, batch["tokens"],
                       fresh_cache(shape.seq_len - 1)),
        defs, rules, param_dtype,
        p_bytes + new_bytes(batch_abs["tokens"]) + cache_bytes,
        lambda out: cache_bytes + new_bytes(out[0]), cache_abs, cache_specs)


def trace_cell(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
               layout: str = "base", device: str = "meta"
               ) -> tuple[dict, float, Cell, int]:
    """Count one step of the cell on ``meta`` (the counterpart of JAX's
    ``lower_compile``; ``device="cpu"`` counts it on real tensors).
    Returns (counts, trace seconds, the cell, its output bytes per chip);
    the model switches are restored whatever happens."""
    try:
        cell = build_cell(cfg, shape, mesh, layout, device)
        model = cell.build()
        if shape.kind != "train":
            cell.step(*cell.inputs(model))     # the bf16 copies, uncounted
        args = cell.inputs(model)
        t0 = time.perf_counter()
        with roof.OpCounter() as counter:
            out = cell.step(*args)
        t_trace = time.perf_counter() - t0
    finally:
        _restore_switches()
    return counter.as_dict(), t_trace, cell, cell.out_bytes(out)


def _fake_mesh(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
               layout: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the sharded trace's mesh: ``mesh``'s, but
    under FSDP-2D, where every spec takes "data" and "model" together
    (the parameters' "embed", the batch) and no constraint keeps a lone
    "model", the two are one "data" axis of their product.  The
    collectives are the same; DTensor in torch 2.11 has no strategy for
    a dim split over two mesh axes."""
    if _layout(cfg, shape, layout)[2] != "fsdp2d":
        return mesh.shape, mesh.axis_names
    sizes = mesh_shape_dict(mesh)
    names = tuple(a for a in mesh.axis_names if a != "model")
    return (tuple(sizes[a] * (sizes["model"] if a == "data" else 1)
                  for a in names), names)


def trace_sharded(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
                  layout: str = "base") -> tuple[roof.CollectiveStats, float]:
    """The cell's step run once as the sharded program over a fake group
    of ``mesh``'s size (the counterpart of JAX's partitioned compile):
    parameters, optimizer state, batch and cache DTensors on ``meta``,
    the collectives DTensor emits counted per chip by kind.  Returns
    (the counts, seconds); the group is destroyed and the model switches
    restored whatever happens.  An op DTensor has no sharding strategy
    for raises, naming the op."""
    t0 = time.perf_counter()
    with group.fake_group(*_fake_mesh(cfg, shape, mesh, layout)) as dmesh:
        try:
            cell = build_cell(cfg, shape, mesh, layout, dmesh=dmesh)
            model = cell.build()
            if shape.kind != "train":
                cell.step(*cell.inputs(model))  # the bf16 copies, uncounted
            args = cell.inputs(model)
            with roof.CollectiveCounter() as counter:
                cell.step(*args)
        finally:
            _restore_switches()
    return counter.stats(), time.perf_counter() - t0


def collectives_entry(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
                      layout: str, cell: str) -> tuple[dict, float | None]:
    """A record's ``collectives``: ``{"counts", "bytes_by_kind"}`` of
    :func:`trace_sharded`, or ``{"error": ...}`` naming the cell and the
    reason when the sharded trace cannot run it (printed to stderr too:
    never a silent zero); and the trace's seconds (``None`` on error)."""
    try:
        stats, t = trace_sharded(cfg, shape, mesh, layout)
    except Exception as e:   # recorded: the cell's term is the result
        msg = f"{cell}: {type(e).__name__}: {e}"
        print("sharded trace failed:", msg, file=sys.stderr)
        return {"error": msg}, None
    return {"counts": stats.counts, "bytes_by_kind": stats.bytes_by_kind}, t


def _collective_bytes(entry: dict) -> int | None:
    return (sum(entry["bytes_by_kind"].values())
            if "bytes_by_kind" in entry else None)


# ---------------------------------------------------------------------------
# depth variants for affine cost extrapolation
# ---------------------------------------------------------------------------
def depth_variants(cfg: ArchConfig):
    """[(cfg_small, n_small), ...], n_full -- n counts the repeating unit."""
    if cfg.shared_attn_every:          # zamba: unit = group of ssm layers
        e = cfg.shared_attn_every
        mk = lambda g: dataclasses.replace(cfg, n_layers=e * g)
        return [(mk(1), 1), (mk(2), 2)], cfg.n_layers // e
    if cfg.is_encoder_decoder:         # whisper: enc+dec vary together
        mk = lambda n: dataclasses.replace(cfg, n_layers=n, enc_layers=n)
        return [(mk(2), 2), (mk(4), 4)], cfg.n_layers
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    mk = lambda n: dataclasses.replace(cfg, n_layers=n + lead)
    return [(mk(2), 2), (mk(4), 4)], cfg.n_layers - lead


def _resident_and_cache(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
                        layout: str) -> tuple[int, int]:
    """Per-chip cache bytes and resident weight bytes of a decode cell
    (JAX's terms; zero for other kinds)."""
    if shape.kind != "decode":
        return 0, 0
    msizes = mesh_shape_dict(mesh)
    cache_abs, cache_specs = _cache(cfg, shape, mesh, layout)
    cache_bytes = memory_lib._sharded_bytes(cache_abs, cache_specs, msizes)
    defs = model_zoo.get_model(cfg).param_defs(cfg)
    rules = pspec_lib.SERVE_RULES if layout == "opt" else None
    dt = torch.bfloat16 if layout == "opt" else None
    resident = memory_lib._sharded_bytes(
        pspec_lib.abstract_params(defs, dtype=dt),
        pspec_lib.resolve_specs(defs, msizes, rules), msizes)
    return cache_bytes, resident


def roofline_cell(cfg: ArchConfig, shape: ShapeCfg, mesh: Mesh,
                  layout: str = "base", full: dict | None = None) -> dict:
    """Three-term roofline from two small-depth counts, extrapolated
    affinely to full depth: the op counts of :func:`trace_cell` and the
    collective bytes of :func:`trace_sharded` at each depth.  ``full``,
    the full-depth counts (with ``collective_bytes`` when they were
    counted), is checked against the line: ``affine_rel_err`` per count,
    ``affine_exact`` when every one is within 1e-9.  A sharded trace that
    fails leaves the collective term ``None`` and its reason in
    ``collective_error``."""
    variants, n_full = depth_variants(cfg)
    samples = []
    errors = []
    for vcfg, n in variants:
        counts, t_trace, _, _ = trace_cell(vcfg, shape, mesh, layout)
        sample = {"n": n, **counts, "t_trace_s": t_trace}
        entry, t_sh = collectives_entry(
            vcfg, shape, mesh, layout,
            f"{cfg.arch_id} x {shape.name} at depth {n}")
        if "error" in entry:
            errors.append(entry["error"])
        else:
            sample.update(collective_bytes=_collective_bytes(entry),
                          collective_counts=entry["counts"],
                          t_sharded_trace_s=t_sh)
        samples.append(sample)
    (s1, s2) = samples
    ex = lambda k: roof.affine_extrapolate(s1[k], s2[k], s1["n"], s2["n"],
                                           n_full)
    keys = ("flops", "bytes", "ops")
    coll_keys = () if errors else ("collective_bytes",)
    out: dict = {"samples": samples, "n_full": n_full}
    if errors:
        out["collective_error"] = errors[0]
    if full is not None:
        rel = {k: abs(ex(k) - full[k]) / max(abs(full[k]), 1)
               for k in keys + tuple(k for k in coll_keys if k in full)}
        out.update(full_depth=full, affine_rel_err=rel,
                   affine_exact=all(v <= 1e-9 for v in rel.values()))
    chips = mesh.size
    cache_bytes, resident = _resident_and_cache(cfg, shape, mesh, layout)
    terms = roof.RooflineTerms(
        flops_per_chip=ex("flops") / chips,
        hbm_bytes_per_chip=ex("bytes") / chips,
        collective_bytes_per_chip=(ex("collective_bytes") if coll_keys
                                   else None),
        chips=chips,
        model_flops=roof.model_flops_for(cfg, shape),
        hbm_bytes_model=roof.analytic_hbm_bytes(
            cfg, shape, mesh_shape_dict(mesh),
            cache_bytes_per_chip=cache_bytes,
            resident_param_bytes=resident),
    )
    return {**out, **terms.as_dict()}


# ---------------------------------------------------------------------------
# per-cell records
# ---------------------------------------------------------------------------
def mesh_name(multi_pod: bool, layout: str = "base") -> str:
    return ("2x16x16" if multi_pod else "16x16") + (
        "" if layout == "base" else f"_{layout}")


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             with_roofline: bool = True, layout: str = "base",
             cfg: ArchConfig | None = None, shape: ShapeCfg | None = None,
             mesh: Mesh | None = None) -> dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh`` override the
    registry's (a reduced config, a small mesh); the defaults are the
    published config, the named shape and the production mesh."""
    cfg = cfg or get_arch(arch_id)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(multi_pod, layout)
    record: dict = {"arch": arch_id, "shape": shape_name, "mesh": name,
                    "layout": layout}
    ok, reason = shape_supported(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    t0 = time.perf_counter()
    counts, t_trace, cell, out_bytes = trace_cell(cfg, shape, mesh, layout)
    mem = memory_lib.budget(
        cfg, shape, mesh_shape_dict(mesh), cell.defs,
        cache_abs=cell.cache_abs, cache_specs=cell.cache_specs,
        train=shape.kind == "train", rules=cell.rules,
        param_dtype=cell.param_dtype)
    record.update(
        status="ok",
        t_trace_s=t_trace,
        memory_analysis={"temp_bytes": None,
                         "argument_bytes": cell.arg_bytes,
                         "output_bytes": out_bytes,
                         "generated_code_bytes": None},
        analytic_memory=mem.as_dict(),
        counts={**counts, "device": "meta",
                "note": "one step of the eager program, full depth; "
                        "global, not per chip"},
    )
    full = dict(counts)
    coll, t_sh = collectives_entry(
        cfg, shape, mesh, layout, f"{arch_id} x {shape_name} x {name}")
    record.update(collectives=coll, t_sharded_trace_s=t_sh)
    if "error" not in coll:
        full["collective_bytes"] = _collective_bytes(coll)
    print(f"[{arch_id} x {shape_name} x {name}] traced in {t_trace:.1f}s; "
          f"analytic mem {mem.total_bytes / 1e9:.2f} GB/chip "
          f"(fits={mem.fits}); counts {counts}; collectives "
          f"{record['collectives']}")
    if with_roofline and not multi_pod:
        record["roofline"] = roofline_cell(cfg, shape, mesh, layout,
                                           full=full)
        r = record["roofline"]
        print(f"  roofline: compute {r['t_compute_s']:.4f}s "
              f"memory {r['t_memory_s']:.4f}s (op-bytes bound "
              f"{r['t_memory_hlo_s']:.4f}s) collective "
              f"{r['t_collective_s']}s -> {r['bottleneck']}-bound; "
              f"useful-FLOP frac {r['useful_flops_fraction']:.3f}; "
              f"roofline frac {r['roofline_fraction']:.4f}; "
              f"affine exact {r['affine_exact']}")
    record["t_total_s"] = time.perf_counter() - t0
    return record


def cell_path(arch_id, shape_name, mesh_name) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.join(
        OUT_DIR, f"{arch_id}__{shape_name}__{mesh_name}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--layout", choices=("base", "opt"), default="base")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, mp) for a in ARCHS for s in SHAPES
                 for mp in (False, True)]
        procs: list[tuple[subprocess.Popen, str]] = []
        failed: list[str] = []
        for a, s, mp in cells:
            path = cell_path(a, s, mesh_name(mp, args.layout))
            if os.path.exists(path) and not args.force:
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--layout", args.layout]
            if mp:
                cmd.append("--multi-pod")
            if args.no_roofline:
                cmd.append("--no-roofline")
            while len(procs) >= args.jobs:
                procs, failed = _reap(procs, failed)
                time.sleep(1)
            print(">>", " ".join(cmd), flush=True)
            procs.append((subprocess.Popen(cmd), f"{a}/{s}/{mp}"))
        while procs:
            procs, failed = _reap(procs, failed)
            time.sleep(1)
        print("FAILED CELLS:", failed if failed else "none")
        sys.exit(1 if failed else 0)

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape are required without --all")
    name = mesh_name(args.multi_pod, args.layout)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       with_roofline=not args.no_roofline,
                       layout=args.layout)
    except Exception as e:   # recorded: the cell's status is the result
        rec = {"arch": args.arch, "shape": args.shape, "mesh": name,
               "layout": args.layout, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        print(rec["traceback"], file=sys.stderr)
    path = cell_path(args.arch, args.shape, name)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", path)
    sys.exit(0 if rec.get("status") in ("ok", "skipped") else 1)


def _reap(procs, failed):
    alive = []
    for p, name in procs:
        if p.poll() is None:
            alive.append((p, name))
        elif p.returncode != 0:
            failed.append(name)
    return alive, failed


if __name__ == "__main__":
    main()
