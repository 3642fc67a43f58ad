"""The control of the comparison that decides ``correct``: the reference
computed in bfloat16, the precision below the configurations' float32,
put in the program's place.  It has to come out not correct.

    python3 portbench/control.py --workload exitmix-333-k4.early \
        --seeds 11 12 13

For each seed it makes the run's own inputs (model, pool, the ring's
batch rows), gives the first ``SAMPLE_CALLS`` calls of the window the
bf16 reference's verdicts in place of the program's, and prints the
numbers the run would compare, one JSON line a seed.  It needs no card
and runs the program not at all; the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys


def numbers(cell, seed: int, traffic: dict | None = None) -> dict:
    from portbench import check, harness
    from portbench.ref import walk, windows
    traffic = cell.traffic if traffic is None else traffic
    pool_rng, batch_rng, _ = harness.seeds(seed)
    x = harness.inputs(cell, traffic, pool_rng, batch_rng)
    fids = x.model.used_features()
    ref = walk.walk(x.model, windows.all_features(x.pool_windows, fids=fids))
    low = walk.walk(x.model, windows.all_features(x.pool_windows,
                                                  rnd=windows.bf16, fids=fids))
    nb = len(x.rows)
    kept = [check.Kept(i, i % nb, low.labels[x.rows[i % nb]],
                       low.recircs[x.rows[i % nb]],
                       low.exit_p[x.rows[i % nb]])
            for i in range(harness.SAMPLE_CALLS)]
    return check.compare(kept, ref, x.rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from portbench import cells, check
    cell = cells.resolve(args.workload)
    for seed in args.seeds:
        got = numbers(cell, seed)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": check.passes(got), "check": got}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
