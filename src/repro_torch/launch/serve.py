"""Serving launcher (port of ``repro.launch.serve``): continuous batching
over a fixed slot pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --slots 4 --requests 12 --max-new 16                 # reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --no-reduced --slots 8 --max-len 2048                # full width
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --device cpu                   # reduced, CPU

``--arch`` takes every registered architecture: ``rwkv6-1.6b``,
``zamba2-2.7b``, the dense and VLM transformers (tinyllama-1.1b,
granite-3-2b, stablelm-3b, minitron-8b, paligemma-3b; served on text
prompts alone) and the MoE transformers (``qwen2-moe-a2.7b``,
``deepseek-v2-236b``).  ``whisper-medium`` is refused with
``SystemExit``, as in the JAX launcher: the batcher has no audio path,
so an encoder-decoder is served through ``serve_step``'s prefill (with
frames) and decode steps instead.

An open request stream served with a FIXED pool of cache slots;
admission into freed slots every engine tick.  ``--device`` defaults to
the card; ``--device cpu`` runs the plain PyTorch path.  ``--reduced``
is on by default as in the JAX launcher, whose ``store_true`` flag with
``default=True`` cannot be turned off; here ``--no-reduced`` serves the
full-width model.  Parameters are random, from a generator seeded with
0, and prompts come from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.distributed import pspec as pspec_lib
from repro_torch.models import model_zoo
from repro_torch.serve.batching import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec serving requires audio frames; "
                         "use the decoder-only archs for this demo")
    dev = resolve_device(args.device)
    zoo = model_zoo.get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.build(cfg, pspec_lib.init_params(zoo.param_defs(cfg), gen,
                                                  dev))

    eng = ContinuousBatcher(cfg, params, slots=args.slots,
                            max_len=args.max_len, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 12)).tolist()
        eng.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    dt = time.perf_counter() - t0
    print(f"completed {stats.completed}/{args.requests} requests in "
          f"{stats.ticks} ticks ({dt:.1f}s on {dev}); decode tokens "
          f"{stats.decode_tokens}; mean slot occupancy "
          f"{np.mean(stats.slot_occupancy):.2f}/{args.slots}")
    return stats


if __name__ == "__main__":
    main()
