"""Fault-tolerance demo on the PyTorch/CUDA port: training with
simulated hard failures, async checkpointing, exactly-once recovery and
straggler detection.

    PYTHONPATH=src python examples/fault_tolerance_torch.py             # the card
    PYTHONPATH=src python examples/fault_tolerance_torch.py --device cpu

``examples/fault_tolerance.py`` on the port's own modules: reduced
``granite-3-2b`` (random parameters from a seeded generator), AdamW at
3e-3, 24 Markov batches of 4 x 32 tokens, a checkpoint every 4 steps and
failures injected after steps 9 and 17.  ``run_with_recovery`` restores
the last committed checkpoint into the live model in place
(``train.checkpoint.restore_into``), replays from it, and the
``StepWatchdog`` flags stragglers.  Checkpoints go to a temporary
directory (under ``TMPDIR``), removed at the end.  ``--device`` defaults
to the card; without one it raises.
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline, on_device
from repro_torch.device import resolve_device
from repro_torch.distributed import pspec
from repro_torch.models import model_zoo
from repro_torch.train.elastic import StepWatchdog, run_with_recovery
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("granite-3-2b").reduced()
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.build(cfg, pspec.init_params(zoo.param_defs(cfg), gen, dev))
    opt = AdamW(lr=3e-3)
    state = opt.init(params)
    raw = make_train_step(cfg, opt)
    losses = []

    def step(s, b):
        s, metrics, _ = raw(s, b, None)
        losses.append((int(s.step), float(metrics["loss"])))
        return s, metrics

    pipe = TokenPipeline(cfg.vocab, batch=4, seq=32)
    place = on_device(dev)
    batches = [place(pipe.batch_at(i)) for i in range(24)]
    root = tempfile.mkdtemp(prefix="ft_demo_")
    wd = StepWatchdog(on_straggler=lambda s, dt, ema: print(
        f"  [watchdog] straggler at step {s}: {dt:.2f}s vs ema {ema:.2f}s"))
    print("training 24 steps with failures injected after steps 9 and 17…")
    try:
        state, rep = run_with_recovery(
            step, state, batches, ckpt_root=root, ckpt_every=4,
            fail_at={9, 17}, watchdog=wd)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"failures={rep.failures} restores={rep.restores} "
          f"steps_run={rep.steps_run} (includes replay) "
          f"final_step={rep.final_step}")
    assert rep.final_step == 24 and rep.restores == 2
    print("ACCEPTANCE: recovered to exactly step 24 through 2 failures OK")
    return {"device": str(dev), "failures": rep.failures,
            "restores": rep.restores, "steps_run": rep.steps_run,
            "final_step": rep.final_step,
            "straggler_flags": rep.straggler_flags, "losses": losses}


if __name__ == "__main__":
    main()
