"""Parameter definitions with logical sharding axes (port of
``repro.distributed.pspec``).

Every model declares its parameters once as a tree (nested dicts) of
:class:`ParamDef`: shape, per-dim *logical* axis names and init rule.
From that one source the port derives materialised parameters
(:func:`init_params`), counts (:func:`param_count`, :func:`param_bytes`),
partition specs under a rule set mapping logical axes to mesh axes
(:func:`resolve_specs`, with JAX's divisibility fallback: a dim that does
not divide its mesh axes is replicated, e.g. 4 KV heads on a 16-way
"model" axis) and abstract parameters on the ``meta`` device
(:func:`abstract_params`, the counterpart of ``ShapeDtypeStruct`` trees).

A spec keeps JAX's shape of value: a tuple with one entry a tensor dim,
each ``None``, an axis name or a tuple of axis names, normalised as
``PartitionSpec`` normalises (a 1-tuple is its name, an empty tuple
``None``).  ``distributed.sharding.NamedSharding`` turns one into DTensor
placements where data is placed.

Logical axes used across the zoo:
  vocab, embed, mlp, heads, kv, head_dim, expert, expert_mlp, lora,
  state, conv, frames
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


# rules: logical axis -> mesh axis (or tuple of mesh axes).  The
# production mesh is ("data", "model"); "pod" stays pure data parallel, so
# parameters are replicated across pods.  "embed" riding the data axis is
# the FSDP (ZeRO-3) dimension.
DEFAULT_RULES: dict[str, Any] = {
    "vocab": "model",
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "expert": "model",
    "expert_mlp": None,
    "head_dim": None,
    "lora": None,
    "state": None,
    "conv": None,
    "frames": None,
    "layers": None,
}

# the train layout for dense architectures: fully sharded over both mesh
# axes (ZeRO-3), no tensor parallelism
FSDP2D_RULES: dict[str, Any] = dict(
    DEFAULT_RULES,
    embed=("data", "model"), vocab=None, mlp=None, heads=None, kv=None,
)

# the serve layout: weights resident (TP over "model", replicated over
# "data"); MoE experts whole on their EP shard, d_ff sharded over "data"
SERVE_RULES: dict[str, Any] = dict(
    DEFAULT_RULES,
    embed=None, expert="model", expert_mlp="data",
)


def spec_entry(axis):
    """One spec entry as ``PartitionSpec`` stores it: a 1-tuple of axes
    is its name, an empty tuple ``None``."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        if not axis:
            return None
        return axis[0] if len(axis) == 1 else axis
    return axis


def _axis_size(mesh_shape: dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh_shape.get(a, 1) for a in axis)
    return mesh_shape.get(axis, 1)


def resolve_spec(d: "ParamDef", mesh_shape: dict[str, int],
                 rules: dict[str, Any] | None = None) -> tuple:
    """The spec of one def: each dim's logical axis through ``rules``
    (``DEFAULT_RULES`` when None), replicated where the dim does not
    divide the mesh axes' size."""
    rules = rules or DEFAULT_RULES
    out = []
    for dim, name in zip(d.shape, d.logical):
        axis = rules.get(name) if name else None
        if axis is not None and dim % _axis_size(mesh_shape, axis) == 0:
            out.append(spec_entry(axis))
        else:
            out.append(None)
    return tuple(out)


def resolve_specs(defs, mesh_shape: dict[str, int],
                  rules: dict[str, Any] | None = None):
    return tree_map(lambda d: resolve_spec(d, mesh_shape, rules), defs)


def abstract_params(defs, dtype: torch.dtype | None = None):
    """A tree of ``meta`` tensors of the defs' shapes and dtypes, nothing
    allocated; ``dtype`` overrides floating leaves (bf16 weights for
    serving), as JAX's does."""
    def mk(d: ParamDef) -> torch.Tensor:
        dt = d.dtype
        if dtype is not None and dt.is_floating_point:
            dt = dtype
        return torch.empty(d.shape, dtype=dt, device="meta")

    return tree_map(mk, defs)


def map_structure(fn: Callable, tree, *others):
    """``fn(leaf, *other_leaves)`` over ``tree``'s leaves, keeping its
    containers: dicts (keys sorted), lists and tuples; ``None`` is an
    empty subtree, as in ``jax.tree``.  Each of ``others`` is walked in
    step and gives, at a leaf of ``tree``, the object at the same place
    (a spec tuple there is one leaf, as ``PartitionSpec`` is in JAX)."""
    if isinstance(tree, dict):
        return {k: map_structure(fn, tree[k], *(o[k] for o in others))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        seq = [map_structure(fn, t, *(o[i] for o in others))
               for i, t in enumerate(tree)]
        return seq if isinstance(tree, list) else tuple(seq)
    if tree is None:
        return None
    return fn(tree, *others)


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
