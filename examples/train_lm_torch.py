"""End-to-end training script on the PyTorch/CUDA port: a
~100M-parameter tinyllama-family model trained for a few hundred steps
on the synthetic Markov stream, with async checkpointing and the step
watchdog.

    PYTHONPATH=src python examples/train_lm_torch.py           # ~100M, 200 steps
    PYTHONPATH=src python examples/train_lm_torch.py --quick   # tiny, 40 steps
    PYTHONPATH=src python examples/train_lm_torch.py --quick --device cpu

``repro_torch.launch.train.main`` with ``examples/train_lm.py``'s
arguments.  Checkpoints go to ``--ckpt-dir``, by default a fresh
temporary directory (under ``TMPDIR``) that is removed at the end, so a
run never resumes from another run's checkpoints.

Acceptance: final loss well below the uniform floor log(vocab), i.e. the
model learned the Markov structure end-to-end through the full stack
(data pipeline -> train step -> AdamW -> checkpointing).  ``--device``
defaults to the card; without one it raises.
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_launch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")

    if args.quick:
        argv = ["--arch", "tinyllama-1.1b", "--reduced",
                "--steps", str(args.steps or 40), "--batch", "8",
                "--seq", "64", "--lr", "1e-2", "--ckpt-dir", ckpt_dir]
    else:
        # ~100M params: d_model 640, 12 layers, vocab 32000
        argv = ["--arch", "tinyllama-1.1b", "--d-model", "640",
                "--layers", "12", "--steps", str(args.steps or 200),
                "--batch", "4", "--seq", "256", "--lr", "3e-3",
                "--ckpt-dir", ckpt_dir, "--microbatches", "2"]
    try:
        losses = train_launch.main(argv + ["--device", str(dev)])
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    floor = np.log(256 if args.quick else 32000)
    final = float(np.mean(losses[-10:]))
    print(f"ACCEPTANCE: final loss {final:.3f} vs uniform floor "
          f"{floor:.3f}: {'OK' if final < floor else 'needs more steps'}")
    return {"device": str(dev), "losses": losses, "final": final,
            "floor": float(floor), "learned": final < floor}


if __name__ == "__main__":
    main()
