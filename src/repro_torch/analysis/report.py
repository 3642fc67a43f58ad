"""Markdown tables from dry-run records (port of ``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report \
        [--dir experiments/dryrun_torch]

The tables read the JAX package's records and the port's alike, and
print the same bytes as JAX's on the same records: the collectives
column, the collective term and a collective-bound cell's hint.  A port
record has no compile step (its ``t_trace_s`` stands in the "compile s"
column).  A cell whose sharded trace failed records
``collectives: {"error": ...}`` and a ``None`` collective term: the
column says "sharded trace error" and the term prints as ``—``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirpath: str) -> dict[tuple, dict]:
    out = {}
    for p in glob.glob(os.path.join(dirpath, "*.json")):
        with open(p) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return out


ARCH_ORDER = ["tinyllama-1.1b", "minitron-8b", "granite-3-2b", "stablelm-3b",
              "rwkv6-1.6b", "whisper-medium", "qwen2-moe-a2.7b",
              "deepseek-v2-236b", "paligemma-3b", "zamba2-2.7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def dryrun_table(recs: dict) -> str:
    lines = ["| arch | shape | 16x16 | 2x16x16 | compile s | analytic GB/chip"
             " (fits) | collectives (single-pod) |",
             "|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r1 = recs.get((a, s, "16x16"))
            r2 = recs.get((a, s, "2x16x16"))
            if r1 is None:
                continue
            if r1.get("status") == "error":
                reason = r1.get("error", "")[:58]
                lines.append(f"| {a} | {s} | error | ? | — | — | {reason} |")
                continue
            if r1.get("status") == "skipped":
                reason = r1.get("reason", "")[:58]
                lines.append(f"| {a} | {s} | skip | skip | — | — | {reason} |")
                continue
            mem = r1["analytic_memory"]
            if "counts" in r1.get("collectives", {}):
                cc = r1["collectives"]["counts"]
                coll = " ".join(f"{k.split('-')[-1][:4]}:{v}"
                                for k, v in cc.items() if v)
            elif "collectives" in r1:
                coll = "sharded trace error"
            else:
                coll = "—"
            t_s = r1.get("t_compile_s", r1.get("t_trace_s"))
            ok2 = "ok" if (r2 or {}).get("status") == "ok" else (
                "skip" if (r2 or {}).get("status") == "skipped" else "?")
            lines.append(
                f"| {a} | {s} | ok | {ok2} | {t_s:.0f} | "
                f"{mem['total_gb']:.1f} ({'y' if mem['fits'] else 'n'}) | "
                f"{coll} |")
    return "\n".join(lines)


def roofline_table(recs: dict, mesh: str = "16x16") -> str:
    lines = ["| arch | shape | t_comp s | t_mem s | t_mem(hlo) s | t_coll s |"
             " bound | 6ND/HLO | roofline frac | fix |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            rec = recs.get((a, s, mesh))
            if rec is None or rec.get("status") != "ok":
                continue
            r = rec.get("roofline")
            if not r:
                continue
            fix = _fix_hint(r["bottleneck"], s)
            lines.append(
                f"| {a} | {s} | {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f}"
                f" | {r['t_memory_hlo_s']:.3f} | "
                f"{_fmt(r['t_collective_s'], '.4f')} | "
                f"{r['bottleneck']} | {r['useful_flops_fraction']:.3f} | "
                f"{r['roofline_fraction']:.4f} | {fix} |")
    return "\n".join(lines)


def _fmt(v, spec: str) -> str:
    """``v`` formatted, or ``—`` for a term the record does not have."""
    return "—" if v is None else format(v, spec)


def _bound(r: dict) -> float:
    """The step-time bound: the largest term the record has."""
    return max(t for t in (r["t_compute_s"], r["t_memory_s"],
                           r["t_collective_s"]) if t is not None)


def _fix_hint(bound: str, shape: str) -> str:
    if bound == "collective":
        if shape == "train_4k":
            return "FSDP-2D layout (kills TP activation ARs)"
        return "resident weights / einsum MoE dispatch"
    if bound == "memory":
        if "decode" in shape or "long" in shape:
            return "cache sweep is the wall: quantise KV / widen batch"
        return "blockwise attention + fusion"
    return "at compute bound: raise useful-FLOP frac (remat policy)"


def opt_compare_table(recs: dict) -> str:
    lines = ["| cell | metric | baseline | optimized | gain |",
             "|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            b = recs.get((a, s, "16x16"))
            o = recs.get((a, s, "16x16_opt"))
            if not b or not o or "roofline" not in (b or {}) \
                    or "roofline" not in (o or {}):
                continue
            rb, ro = b["roofline"], o["roofline"]
            tb, to = _bound(rb), _bound(ro)
            lines.append(
                f"| {a} x {s} | step-time bound | {tb:.4f}s | {to:.4f}s | "
                f"{tb / to:.1f}x |")
            lines.append(
                f"| | roofline fraction | {rb['roofline_fraction']:.4f} | "
                f"{ro['roofline_fraction']:.4f} | "
                f"{ro['roofline_fraction'] / max(rb['roofline_fraction'], 1e-9):.1f}x |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "experiments",
        "dryrun_torch"))
    ap.add_argument("--table", choices=("dryrun", "roofline", "opt", "all"),
                    default="all")
    args = ap.parse_args()
    recs = load(args.dir)
    if args.table in ("dryrun", "all"):
        print("## Dry-run matrix\n")
        print(dryrun_table(recs))
    if args.table in ("roofline", "all"):
        print("\n## Roofline (single-pod 16x16, baseline layout)\n")
        print(roofline_table(recs))
    if args.table in ("opt", "all"):
        print("\n## Baseline vs optimized cells\n")
        print(opt_compare_table(recs))


if __name__ == "__main__":
    main()
