"""Fit one platform's row of ``costmodel.DEFAULT_COEFFS``.

    PYTHONPATH=src python -m repro_torch.tuning              # the card
    PYTHONPATH=src python -m repro_torch.tuning --device cpu

Trains the engine's model on ``make_dataset("d2", --flows)`` with the
numpy trainer, times each backend on the training split's windows
through ``costmodel.calibrate`` and prints the fitted row as Python,
with the host's core count (the CPU row) or the card's name (the CUDA
row, which ``chip_smoke.py`` phase ``tune`` fits at the main path's size).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.core.inference import Engine
from repro_torch.core.partition import train_partitioned_dt
from repro_torch.flows.synthetic import make_dataset
from repro_torch.flows.windows import window_features, window_packets
from repro_torch.tuning.costmodel import TERMS, calibrate


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--flows", type=int, default=6000)
    ap.add_argument("--sizes", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    tr, _ = make_dataset("d2", n_flows=args.flows).split()
    pdt = train_partitioned_dt(window_features(tr, 3, device="cpu"),
                               tr.labels, partition_sizes=[2, 3, 2], k=4)
    eng = Engine.from_model(pdt, device=args.device)
    coeffs = calibrate(eng, window_packets(tr, 3), probe_sizes=args.sizes,
                       repeat=args.repeat)
    import torch
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else f"cpu, {os.cpu_count()} cores")
    print(f"# {where}; probes {args.sizes}")
    for backend, c in coeffs.items():
        terms = ", ".join(f"{t}={getattr(c, t)!r}" for t in TERMS)
        print(f'"{backend}": Coefficients({terms}),')


if __name__ == "__main__":
    main()
