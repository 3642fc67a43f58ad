"""The train step (port of ``repro.train.train_step``): loss -> gradients
-> optional microbatch accumulation -> optional int8 gradient compression
with error feedback -> AdamW.

The gradients are ``torch.autograd.grad`` of ``zoo.loss_fn(cfg, model,
batch)`` with respect to the parameter tree's leaves (a parameter the
loss does not reach gets zeros, as ``jax.grad`` gives).  Microbatches
follow JAX's scan: f32 zeros, then ``loss_acc + loss / m`` and ``g_acc +
g / m``, one microbatch after another.  There is no jit and no donation:
the optimizer writes the state in place, which keeps one copy of it in
memory as donation does in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import compression
from repro_torch.models.layers import placed
from repro_torch.distributed.pspec import tree_from_items, tree_items, tree_map
from repro_torch.models import model_zoo
from repro_torch.train.optimizer import AdamW, TrainState, param_tree


@dataclasses.dataclass(frozen=True)
class TrainLoopCfg:
    microbatches: int = 1
    compress_grads: bool = False


def loss_and_grads(cfg: ArchConfig, model, batch: dict,
                   microbatches: int = 1) -> tuple[torch.Tensor, dict]:
    """The loss of ``batch`` and its gradients, a tree under the
    parameters' names, before compression and the optimizer: what a train
    step of ``make_train_step`` computes first.  With ``microbatches`` > 1
    the batch is split on its leading axis and the loss and gradients are
    accumulated in f32 as JAX's scan does."""
    zoo = model_zoo.get_model(cfg)

    def value_and_grad(batch: dict) -> tuple[torch.Tensor, dict]:
        items = tree_items(param_tree(model))
        with torch.enable_grad():
            loss = zoo.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(
                loss, [p for _, p in items], allow_unused=True,
                materialize_grads=True)
            # DTensor gradients (the dry run's sharded trace) come back
            # with pending partial sums: reduce each into its parameter's
            # placements once, the data-parallel gradient reduction
            grads = [placed(g, getattr(p, "placements", None))
                     for g, (_, p) in zip(grads, items)]
        return loss.detach(), tree_from_items([n for n, _ in items], grads)

    if microbatches <= 1:
        return value_and_grad(batch)
    m = microbatches
    mb = {k: x.reshape((m, x.shape[0] // m) + x.shape[1:])
          for k, x in batch.items()}
    tree = param_tree(model)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=tree_items(tree)[0][1].device)
    g_acc = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), tree)
    acc_leaves = [a for _, a in tree_items(g_acc)]
    for i in range(m):
        loss, g = value_and_grad({k: x[i] for k, x in mb.items()})
        loss_acc = loss_acc + loss / m
        for a, (_, gi) in zip(acc_leaves, tree_items(g)):
            a.add_(gi / m)
        del g
    return loss_acc, g_acc


def make_train_step(cfg: ArchConfig, opt: AdamW,
                    loop: TrainLoopCfg = TrainLoopCfg()) -> Callable:
    """Returns step(state, batch, comp_err) -> (state, metrics, comp_err);
    ``state.params`` is the model module, ``batch`` a dict of tensors on
    its device with the global batch on the leading axis."""
    def step(state: TrainState, batch: dict, comp_err: dict | None = None):
        loss, grads = loss_and_grads(cfg, state.params, batch,
                                     loop.microbatches)
        if loop.compress_grads:
            grads, comp_err = compression.compress_grads(grads, comp_err)
        new_state, metrics = opt.update(state, grads)
        metrics["loss"] = loss
        return new_state, metrics, comp_err

    return step


def init_comp_err(params) -> dict:
    """Zero residuals, f32, shaped as the parameter tree."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device),
                    param_tree(params))
