"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --steps 30 --batch 8 --seq 512 \\
        --microbatches 2 --ckpt-dir ckpt             # full width, the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --steps 20 --seq 64 \\
        --device cpu                                 # reduced, CPU

Wires together: config -> model -> data pipeline (prefetching Markov
stream) -> AdamW train step (the state updated in place) -> async
checkpointing -> step watchdog (straggler flags) -> recovery on restart
(resumes from the last committed checkpoint and the matching stream
position).  The flags and defaults are the JAX launcher's, plus
``--device`` (the card by default, ``cpu`` on request).  Parameters come
from ``pspec.init_params`` with a generator seeded from ``--seed``.
``whisper-medium`` is refused: the Markov batch has no audio frames,
and the JAX launcher fails on its first step for the same reason.

:func:`main` returns the per-step losses, as JAX's does; :func:`run`
also returns the final state, each step's seconds and the writer's log.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.tokens import TokenPipeline, on_device
from repro_torch.device import resolve_device
from repro_torch.distributed import pspec as pspec_lib
from repro_torch.models import model_zoo
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.elastic import StepWatchdog
from repro_torch.train.optimizer import AdamW, TrainState, warmup_cosine
from repro_torch.train.train_step import TrainLoopCfg, make_train_step


@dataclasses.dataclass
class TrainRun:
    losses: list[float]        # one a step run, from start_step + 1 on
    step_s: list[float]        # each step's seconds (to its loss on the host)
    start_step: int
    resumed_from: str | None
    state: TrainState
    ckpt_log: list[dict]       # AsyncCheckpointer.log (empty without a dir)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model on CPU)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def run(argv=None) -> TrainRun:
    args = _parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, n_heads=max(args.d_model // 64, 1),
            n_kv_heads=max(min(cfg.n_kv_heads, args.d_model // 64), 1),
            d_ff=args.d_model * 3, d_head=64)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.is_encoder_decoder:
        raise SystemExit(
            f"{cfg.arch_id}: encoder-decoder training needs audio frames, "
            "and the Markov token batch has none (the decoder would read "
            "an encoder output from a cache that a train step does not "
            "have)")
    dev = resolve_device(args.device)

    zoo = model_zoo.get_model(cfg)
    defs = zoo.param_defs(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, 20, args.steps))
    loop = TrainLoopCfg(microbatches=args.microbatches,
                        compress_grads=args.compress_grads)
    step_fn = make_train_step(cfg, opt, loop)

    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=args.seed)
    place = on_device(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = opt.init(zoo.build(cfg, pspec_lib.init_params(defs, gen, dev)))
    start_step = 0
    last = None
    if args.ckpt_dir:
        last = ckpt_lib.latest_committed(args.ckpt_dir)
        if last:
            state, _ = ckpt_lib.restore_into(last, state)
            start_step = int(state.step)
            print(f"resumed from {last} at step {start_step}")

    n_params = pspec_lib.param_count(defs)
    print(f"arch={cfg.arch_id} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    writer = ckpt_lib.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    wd = StepWatchdog(on_straggler=lambda s, dt, ema: print(
        f"  [watchdog] step {s} took {dt:.2f}s (ema {ema:.2f}s)"))
    comp_err = None
    losses, step_s = [], []
    it = pipe.iterate(start_step)
    for i in range(start_step, args.steps):
        batch = place(next(it))
        t0 = time.perf_counter()
        state, metrics, comp_err = step_fn(state, batch, comp_err)
        loss = float(metrics["loss"])
        losses.append(loss)
        step_s.append(time.perf_counter() - t0)
        wd.observe(i + 1, step_s[-1])
        if (i + 1) % args.log_every == 0 or i == start_step:
            print(f"step {i+1:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if writer and (i + 1) % args.ckpt_every == 0:
            writer.save(state)
    it.close()
    if writer:
        writer.save(state)
        writer.wait()
    print(f"done. first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}; "
          f"uniform floor {np.log(cfg.vocab):.3f}")
    return TrainRun(losses=losses, step_s=step_s, start_step=start_step,
                    resumed_from=last, state=state,
                    ckpt_log=writer.log if writer else [])


def main(argv=None) -> list[float]:
    return run(argv).losses


if __name__ == "__main__":
    main()
