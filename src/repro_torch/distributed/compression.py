"""Gradient compression, the train step's half (port of the jit-level half
of ``repro.distributed.compression``).

int8 quantisation per tensor (symmetric, max-abs scale) with the
quantisation residual carried into the next step (error feedback,
arXiv:1901.09847), so the compression is unbiased over time.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
quantised values and the residuals equal JAX's bit for bit.

``compressed_psum``, the wire-level collective under ``shard_map``, is
part of the multi-device half (ROADMAP A.11(f)).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.pspec import tree_from_items, tree_items

BITS = 8
_LEVELS = 2 ** (BITS - 1) - 1   # 127


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)) / _LEVELS, min=1e-30)
    q = torch.clamp(torch.round(g / scale), -_LEVELS, _LEVELS)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads(grads: dict, err: dict | None = None
                   ) -> tuple[dict, dict]:
    """Quantise / dequantise each leaf of ``grads`` after adding the
    carried residual ``err`` (zeros when None).  Returns (grads', new_err),
    trees under the same names."""
    items = tree_items(grads)
    names = [n for n, _ in items]
    flat_err = ([None] * len(items) if err is None
                else [e for _, e in tree_items(err)])
    out_g, out_e = [], []
    for (_, g), e in zip(items, flat_err):
        # zeros are added too when there is no residual, as JAX does
        # (-0.0 + 0.0 is +0.0)
        gf = g.to(torch.float32) + (0.0 if e is None else e)
        deq = _dequantize(*_quantize(gf))
        out_g.append(deq.to(g.dtype))
        out_e.append(gf - deq)
    return tree_from_items(names, out_g), tree_from_items(names, out_e)


def compression_ratio(grads: dict) -> float:
    """Wire bytes int8 / bf16 baseline (~0.5)."""
    total = sum(g.numel() for _, g in tree_items(grads))
    return (total * 1 + 4) / (total * 2)
