"""Shared layer library, the part RWKV6 uses (port of
``repro.models.layers``).

The JAX dtype steps are kept: products run in bf16 (``COMPUTE_DTYPE``,
each weight cast at its product), norm statistics and the loss in f32,
parameters stay f32.  ``shard`` and ``scan_layers`` have no counterpart:
the port runs on one card and loops over the layers in Python.
Attention and the gated MLPs wait for their families (ROADMAP A.11).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.pspec import ParamDef

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def groupnorm(x: torch.Tensor, n_groups: int,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim (RWKV6 head-wise ln_x), no affine."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.reshape(*lead, d).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits / loss
# ---------------------------------------------------------------------------
def embed_defs(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "embed"), init="embed")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()].to(COMPUTE_DTYPE)


def logits(table_or_head: torch.Tensor, x: torch.Tensor,
           transpose: bool) -> torch.Tensor:
    """Final projection: ``x @ head`` ((D, V) head) or ``x @ table.T``
    (a tied (V, D) table), in the compute dtype."""
    w = table_or_head.to(COMPUTE_DTYPE)
    return x.to(COMPUTE_DTYPE) @ (w.T if transpose else w)


def cross_entropy(lg: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL with an f32 logsumexp."""
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
