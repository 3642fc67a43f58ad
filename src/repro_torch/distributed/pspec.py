"""Parameter definitions (port of the parameter half of
``repro.distributed.pspec``).

Every model declares its parameters once as a tree (nested dicts) of
:class:`ParamDef`: shape, per-dim *logical* axis names and init rule.
From that one source the port derives materialised parameters
(:func:`init_params`) and counts (:func:`param_count`,
:func:`param_bytes`) without allocating anything.  The logical axes are
kept so that the sharding rules (``resolve_spec``, ROADMAP A.11)
can be ported onto the same trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Logical = tuple[str | None, ...]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: Logical
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float | None = None  # stddev override (default fan-in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a tree of nested dicts (keys sorted, the
    order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_items(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(dotted.path, leaf)`` pairs, e.g. ``("layers.tm.w_r", ...)``."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def tree_from_items(names: list[str], leaves) -> dict:
    """The nested dict whose ``tree_items`` are ``zip(names, leaves)``."""
    tree: dict = {}
    for name, leaf in zip(names, leaves):
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def stack_defs(d: ParamDef, n: int) -> ParamDef:
    """Stack a per-layer def across ``n`` layers."""
    return dataclasses.replace(
        d, shape=(n,) + d.shape, logical=("layers",) + d.logical)


def stack_tree(defs, n: int):
    return tree_map(lambda d: stack_defs(d, n), defs)


def init_params(defs, generator: torch.Generator,
                device: "str | torch.device | None" = None):
    """Materialise a tree of defs with the JAX package's init rules:
    zeros, ones, normal x 0.02 (``embed``, or ``scale``) and normal x
    fan_in^-1/2 (fan_in = the second-to-last dim).  Draws come from
    ``generator`` in leaf order, so they are not JAX's draws; the
    generator must live on ``device``."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def mk(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        if d.init == "embed":
            scale = d.scale if d.scale is not None else 0.02
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = d.scale if d.scale is not None else fan_in ** -0.5
        x = torch.randn(d.shape, generator=generator, dtype=d.dtype,
                        device=dev)
        return x.mul_(scale)

    return tree_map(mk, defs)


def param_bytes(defs) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in tree_leaves(defs))


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))
