"""Gradient compression (port of ``repro.distributed.compression``).

At 2+ pods the gradient all-reduce crosses the slow inter-pod link; the
exchange is compressed: int8 quantisation per tensor (symmetric, max-abs
scale), the quantised values summed, dequantised, and the quantisation
residual carried into the next step (error feedback, arXiv:1901.09847),
so the compression is unbiased over time.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the quantised values and the residuals
equal JAX's bit for bit.

:func:`compressed_psum` is the wire-level collective (JAX's runs under
``shard_map``; here every rank of the group calls it);
:func:`compress_grads` is the train step's transform, the same numerics
with the sum left to the caller.
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
def compressed_psum(g: torch.Tensor, group, err: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean of ``g`` over ``group`` with error feedback.

    Collective: every rank of ``group`` calls it.  ``group`` is a process
    group, or a ``(DeviceMesh, axis name)`` pair (that axis's group of this
    rank).  JAX's steps in JAX's order: the group agrees on one scale (an
    all-reduce MAX of the local max-abs), quantises, keeps the residual,
    sums the int8 levels as int32 (an all-reduce SUM) and divides by the
    group's size.  Returns ``(mean, new_err)``, f32."""
    import torch.distributed as dist

    if isinstance(group, tuple):
        mesh, axis = group
        group = mesh.get_group(axis)
    gf = g.to(torch.float32)
    if err is not None:
        gf = gf + err
    amax = torch.max(torch.abs(gf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax / _LEVELS, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -_LEVELS, _LEVELS)
    new_err = gf - q * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    # the size as a tensor on the data's device, so the division is a
    # division on the card too (a host scalar would be a reciprocal there)
    n = torch.tensor(float(dist.get_world_size(group)), device=gf.device)
    return total.to(torch.float32) * scale / n, new_err


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
