"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload exitmix-333-k4.early --seed 7 \
        --seconds 10 --trace 0

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` records a bounded traced window and reports
its per-layer metrics.  Both judge the sampled calls' verdicts against
the reference.  The last line of standard output is one JSON object;
the last lines of standard error are the numbers compared, each beside
its limit.  Exits 2 without a CUDA card (or with fewer than the cell
asks for), 3 if JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"


def _paths_and_caches() -> None:
    # the script's own directory would shadow standard modules (trace)
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["SPLIDT_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")


def _power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths_and_caches()

    import torch

    from portbench import cells, check, harness, imports
    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test: fail here if absent)
    out, info = harness.run(cell, seed=args.seed, seconds=args.seconds,
                            traced=bool(args.trace),
                            device=torch.device("cuda", 0), t_start=T_START)
    bad = imports.foreign(sys.modules)
    if bad:
        print("loaded JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    info["card"] = _power_limit()
    print("info " + json.dumps(info), file=sys.stderr)
    for line in check.lines(out["check"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
