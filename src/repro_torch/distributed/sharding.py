"""Whole-program sharding resolution (port of
``repro.distributed.sharding``): parameters, optimizer state, batches
and KV/state caches onto a mesh, and flow batches over a
:class:`~repro_torch.launch.mesh.FlowMesh`.

Parameter and optimizer specs come from the ``ParamDef`` logical axes
(``pspec.resolve_specs``).  Batches and caches are resolved by JAX's
dimension-role rules:

  * batch dims ride the data-parallel axes when divisible;
  * head dims ride "model";
  * long sequence/cache dims ride "model" for decode and "data" when the
    batch axis is unusable (batch 1: sequence parallelism).

The rules read only the mesh's axis names and sizes, so they take an
abstract :class:`~repro_torch.launch.mesh.Mesh` or a runtime
``DeviceMesh`` alike.  JAX's ``batch_axes`` reads the module global
``layers.BATCH_AXES``, which ``layers.set_layout("fsdp2d")`` rewrites; the
port has no such global and takes the layout as an argument (``"tp"``:
("pod", "data"); ``"fsdp2d"``: ("pod", "data", "model")).

:class:`NamedSharding` pairs a mesh and a spec and gives the spec's
DTensor placements; :func:`place_abstract` places a tree of abstract
tensors as DTensors with ``meta`` local shards (the dry run's sharded
trace).  The streaming scheduler's flow batches split into
one contiguous shard a device, in mesh order (:func:`flow_shards`).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import pspec
from repro_torch.launch.mesh import FlowMesh, mesh_axis_names, mesh_shape_dict

LAYOUT_BATCH_AXES = {"tp": ("pod", "data"),
                     "fsdp2d": ("pod", "data", "model")}


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (abstract or runtime), as JAX's
    ``NamedSharding``."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: a tensor dim on one axis is
        ``Shard(dim)`` on that mesh dim, a dim on a tuple of axes
        ``Shard(dim)`` on each of them, every other mesh dim
        ``Replicate()``.  DTensor splits a dim sharded on several mesh
        dims in mesh-dim order, which is JAX's split only when the tuple
        lists its axes in the mesh's order: a tuple out of order raises
        ``ValueError`` (it is never reordered), as do an axis the mesh
        lacks and an axis taken twice."""
        from torch.distributed.tensor import Replicate, Shard

        names = mesh_axis_names(self.mesh)
        out: list = [Replicate()] * len(names)
        used: set[str] = set()
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                if a not in names:
                    raise ValueError(f"spec {self.spec}: axis {a!r} is not "
                                     f"on the mesh {names}")
                if a in used:
                    raise ValueError(f"spec {self.spec}: axis {a!r} is "
                                     "used twice")
                used.add(a)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"spec {self.spec}: {axes} is out of the mesh's axis "
                    f"order {names}; DTensor would split the dim in mesh "
                    "order, which is not JAX's split")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


def batch_axes(mesh, layout: str = "tp") -> tuple[str, ...]:
    """The data-parallel axes of ``mesh`` under ``layout``."""
    names = mesh_axis_names(mesh)
    return tuple(a for a in LAYOUT_BATCH_AXES[layout] if a in names)


def flow_batch_devices(mesh: FlowMesh) -> int:
    """How many ways the flow axis splits: the mesh's ``"data"`` size."""
    return mesh_shape_dict(mesh)["data"]


def flow_shards(n_rows: int, n_devices: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` row bounds of each device's shard of ``n_rows`` flows:
    ``ceil(n_rows / n_devices)`` rows a device in order, the last shards
    shorter or empty when the rows do not divide."""
    if n_devices <= 0:
        raise ValueError("n_devices must be positive")
    per = -(-n_rows // n_devices)
    return [(min(j * per, n_rows), min((j + 1) * per, n_rows))
            for j in range(n_devices)]


def batch_spec(mesh, shape: tuple[int, ...], layout: str = "tp") -> tuple:
    """Shard the leading (global-batch) dim over the data-parallel axes;
    with a batch that does not divide them (batch 1, long context), the
    largest long dim over "data"."""
    sizes = mesh_shape_dict(mesh)
    axes = batch_axes(mesh, layout)
    total = math.prod(sizes[a] for a in axes)
    if shape and _div(shape[0], total):
        return (pspec.spec_entry(axes),) + (None,) * (len(shape) - 1)
    spec: list = [None] * len(shape)
    for i, d in sorted(enumerate(shape), key=lambda t: -t[1]):
        if i == 0:
            continue
        if _div(d, sizes.get("data", 1)) and d >= sizes.get("data", 1) * 8:
            spec[i] = "data"
            break
    return tuple(spec)


def cache_spec(mesh, shape: tuple[int, ...], cfg: ArchConfig,
               opt: bool = True, layout: str = "tp") -> tuple:
    """KV/state cache sharding, JAX's rules by dim size: the batch (==
    global batch) -> the data-parallel axes; a dim equal to n_kv/n_heads
    (or B*H products) -> "model"; the long seq dim -> "model" if the batch
    is sharded, else "data" (SP).  The stacked-layer dim in front is
    recognised by value (the arch's layer counts) and never sharded."""
    sizes = mesh_shape_dict(mesh)
    dp = batch_axes(mesh, layout)
    dp_total = math.prod(sizes[a] for a in dp) if dp else 1
    model = sizes.get("model", 1)
    spec: list = [None] * len(shape)
    if not shape:
        return ()
    lead = cfg.moe.first_dense_layers if cfg.moe else 0
    layer_counts = {cfg.n_layers, cfg.n_layers - lead, cfg.enc_layers}
    if cfg.shared_attn_every:
        layer_counts.add(cfg.n_layers // cfg.shared_attn_every)
    layer_counts.discard(0)
    used_model = used_seq = used_batch = False
    # pass 1: batch and head dims.  Head dims take "model" before long
    # sequence dims when the head count divides it, so a window-sliced
    # cache stays shard-local
    head_sizes = {cfg.n_heads, cfg.n_kv_heads}
    for i, d in enumerate(shape):
        if i == 0 and len(shape) >= 3 and d in layer_counts:
            continue   # stacked layer dim
        if not used_batch and _div(d, dp_total) and d >= dp_total and i <= 1:
            spec[i] = dp      # raw until the end, as JAX's list holds it
            used_batch = True
            continue
        if (opt and not used_model and i >= 2 and d in head_sizes
                and cfg.sliding_window and _div(d, model)):
            spec[i] = "model"
            used_model = True
            used_seq = True   # window slice must stay shard-local
    # pass 2: remaining model-axis candidates (latent dims, long seq)
    for i, d in enumerate(shape):
        if spec[i] is not None or (i == 0 and len(shape) >= 3
                                   and d in layer_counts):
            continue
        if (not used_model and d >= model and _div(d, model)
                and d <= max(cfg.n_heads, cfg.d_model) and i >= 2):
            spec[i] = "model"
            used_model = True
            continue
        if not used_seq and d >= 4096 and i >= 1:
            ax = "model" if not used_model and _div(d, model) else (
                "data" if not used_batch and _div(d, sizes.get("data", 1))
                else None)
            if ax:
                spec[i] = ax
                used_seq = used_model = True
            continue
    return tuple(pspec.spec_entry(e) for e in spec)


def train_state_shardings(cfg: ArchConfig, mesh, defs=None, rules=None):
    """A ``TrainState`` of :class:`NamedSharding`: the parameters' specs,
    ``mu`` and ``nu`` mirroring them, the step replicated."""
    from repro_torch.models import model_zoo
    from repro_torch.train.optimizer import TrainState
    defs = defs or model_zoo.get_model(cfg).param_defs(cfg)
    specs = pspec.resolve_specs(defs, mesh_shape_dict(mesh), rules)
    named = pspec.tree_map(lambda s: NamedSharding(mesh, s), specs)
    return TrainState(step=NamedSharding(mesh, ()), params=named, mu=named,
                      nu=named)


def tree_shardings(mesh, tree, spec_fn):
    """A tree of abstract (or real) tensors -> a tree of
    :class:`NamedSharding` through ``spec_fn(shape)``."""
    return pspec.map_structure(
        lambda x: NamedSharding(mesh, spec_fn(tuple(x.shape))), tree)


def batch_shardings(cfg: ArchConfig, mesh, batch_abs, layout: str = "tp"):
    return tree_shardings(mesh, batch_abs,
                          lambda s: batch_spec(mesh, s, layout))


def cache_shardings(cfg: ArchConfig, mesh, cache_abs, opt: bool = True,
                    layout: str = "tp"):
    return tree_shardings(mesh, cache_abs,
                          lambda s: cache_spec(mesh, s, cfg, opt, layout))


def unit_dims_whole(placements, shape) -> tuple:
    """``placements`` with a split of a dim of extent 1 replaced by
    ``Replicate()``.  Such a split exists only on a mesh axis of one
    chip (the rules' fallback keeps the dim whole on any larger axis),
    where the two hold the same data; DTensor's view rules would drop
    the unit dim and refuse the split."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and shape[p.dim] == 1
                 else p for p in placements)


def place_abstract(tree, shardings):
    """A tree of tensors and a tree of :class:`NamedSharding` on a
    runtime mesh -> DTensors of the same global shapes and strides.  A
    leaf on ``meta`` gets a ``meta`` local shard of one shard's shape:
    nothing is allocated (the dry run's sharded trace).  A leaf with
    values gets this rank's shard of them (``distribute_tensor``; the
    tests run a world of one rank this way).  Leaves that are not
    tensors (the port's host cache lengths) pass through.  The specs
    come from the rules (``train_state_shardings``, ``batch_shardings``,
    ``cache_shardings``), whose fallback replicates a dim that does not
    divide its axes; a sharded dim that does not divide raises."""
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    def one(t, ns):
        if not isinstance(t, torch.Tensor):
            return t
        placements = unit_dims_whole(ns.placements(), t.shape)
        local = list(t.shape)
        for mesh_dim, p in enumerate(placements):
            if isinstance(p, Shard):
                n = ns.mesh.size(mesh_dim)
                if local[p.dim] % n:
                    raise ValueError(
                        f"spec {ns.spec} of shape {tuple(t.shape)}: dim "
                        f"{p.dim} does not divide {n} ways")
                local[p.dim] //= n
        if t.device.type != "meta":
            return distribute_tensor(t, ns.mesh, placements)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), ns.mesh,
            placements, run_check=False, shape=t.shape, stride=t.stride())

    return pspec.map_structure(one, tree, shardings)
