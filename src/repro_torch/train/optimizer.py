"""AdamW and the warmup-cosine schedule (port of ``repro.train.optimizer``).

The optimizer state mirrors the parameter tree: ``mu`` and ``nu`` are
nested dicts of f32 tensors under the JAX tree's names, taken in
``pspec.tree_items`` order (JAX's sorted-key flatten order).  ``params``
is either such a tree or the model module whose parameters are those
tensors (``nn.Parameter`` names such as ``layers.attn.wq`` are the JAX
paths).

:meth:`AdamW.update` keeps JAX's arithmetic op for op (the global norm
summed leaf by leaf in tree order, in f32; the clip scale; the bias
corrections ``1 - b ** step`` in f32; weight decay on every leaf of
``ndim >= 2``, stacked per-layer norm scales included) and writes the
parameters, ``mu`` and ``nu`` in place under ``torch.no_grad()``.  In
place is what donation is in JAX: one copy of the state in memory.  It
also bumps each parameter's ``_version``, which is what
``LMModule.bf16`` keys its cached bf16 copies on, so a model served
after a step never reads stale weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.distributed.pspec import tree_from_items, tree_items, tree_map


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor          # () int32, on the state's device
    params: Any                 # tree of tensors, or the model module
    mu: dict
    nu: dict


def param_tree(params) -> dict:
    """``params`` as a nested dict of its tensors (the tensors themselves,
    not copies): a module's parameters nested by name, or the tree as
    given."""
    if not isinstance(params, nn.Module):
        return params
    named = dict(params.named_parameters())
    return tree_from_items(list(named), list(named.values()))


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once, as XLA divides (``float / Tensor`` in
    torch multiplies by the reciprocal)."""
    return torch.div(torch.tensor(num, dtype=den.dtype, device=den.device),
                     den)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``peak_lr`` over ``warmup`` steps, then a
    cosine down to ``floor * peak_lr`` at ``total``; in f32 tensors, with
    JAX's order of operations."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> TrainState:
        """Step 0 and zero moments beside ``params`` (a tree or a module,
        kept as given), on the parameters' device."""
        tree = param_tree(params)
        leaves = [p for _, p in tree_items(tree)]
        zeros = lambda: tree_map(torch.zeros_like, tree)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            params=params, mu=zeros(), nu=zeros())

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, state: TrainState, grads: dict
               ) -> tuple[TrainState, dict]:
        """One step: ``grads`` is a tree under the parameters' names.  The
        parameters, ``mu`` and ``nu`` are written in place; the returned
        state holds them and the new step.  Metrics: ``grad_norm`` (before
        the clip) and ``lr``, f32 tensors."""
        flat_p = [p for _, p in tree_items(param_tree(state.params))]
        flat_g = [g for _, g in tree_items(grads)]
        flat_m = [m for _, m in tree_items(state.mu)]
        flat_v = [v for _, v in tree_items(state.nu)]
        if not len(flat_g) == len(flat_m) == len(flat_v) == len(flat_p):
            raise ValueError(
                f"grads, mu and nu must have the parameters' {len(flat_p)} "
                f"leaves; got {len(flat_g)}, {len(flat_m)}, {len(flat_v)}")
        # global-norm clip (f32), summed leaf by leaf in tree order
        gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
                  for g in flat_g)
        gnorm = torch.sqrt(gsq)
        scale = torch.minimum(torch.ones_like(gnorm), _div(
            self.grad_clip, torch.clamp(gnorm, min=1e-9)))
        step = state.step + 1
        lr = self._lr(step)
        b1c = 1 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                         device=step.device),
                            step.to(torch.float32))
        b2c = 1 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                         device=step.device),
                            step.to(torch.float32))
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g = g.to(torch.float32) * scale
            m.mul_(self.b1).add_(g * (1 - self.b1))
            v.mul_(self.b2).add_(g * (1 - self.b2) * g)
            delta = torch.div(m, b1c)
            delta.div_(torch.div(v, b2c).sqrt_().add_(self.eps))
            if self.weight_decay and p.dim() >= 2:   # decay matrices only
                delta.add_(p.to(torch.float32) * self.weight_decay)
            p.sub_(delta.mul_(lr).to(p.dtype))
        metrics = {"grad_norm": gnorm, "lr": lr}
        return TrainState(step=step, params=state.params, mu=state.mu,
                          nu=state.nu), metrics
