"""Serving example on the PyTorch/CUDA port: continuous batching over a
fixed cache-slot pool -- the LM-side incarnation of SpliDT's register
reuse.

    PYTHONPATH=src python examples/serve_lm_torch.py                # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

``repro_torch.launch.serve.main`` with ``examples/serve_lm.py``'s
arguments (reduced ``granite-3-2b``, 3 slots, 9 requests, 12 new tokens
each; random parameters from a seeded generator).  ``--device``
defaults to the card; without one it raises.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_launch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    stats = serve_launch.main([
        "--arch", "granite-3-2b", "--slots", "3", "--requests", "9",
        "--max-new", "12", "--device", str(dev),
    ])
    assert stats.completed == 9
    print("ACCEPTANCE: all requests served through the fixed slot pool OK")
    return {"device": str(dev), "completed": stats.completed,
            "ticks": stats.ticks, "decode_tokens": stats.decode_tokens,
            "max_occupancy": max(stats.slot_occupancy)}


if __name__ == "__main__":
    main()
