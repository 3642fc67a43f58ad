"""Checkpoints with an async writer and restore onto a mesh (port of
``repro.train.checkpoint``).

The files are the JAX package's: ``arrays.npz`` with one array per leaf
under its dotted path (``params.layers.attn.wq``, ``mu.embed``, ...,
``step``), ``manifest.json`` with the tree ``template``, ``step``,
``extra`` and ``time``, and the ``COMMITTED`` marker written last.  A
checkpoint that either package writes restores in the other, which is
the training state's cross-package path.

A state's leaves are tensors on one device, or DTensors on a runtime
mesh.  A state with DTensor leaves is saved collectively: every rank
gathers each leaf (``full_tensor()``), the group's rank 0 writes the
files, and a barrier follows, so no rank returns before ``COMMITTED``
exists.  As in JAX's single-controller harness, the full arrays are
written; a restore places them onto ANY mesh -- a checkpoint written on
4 ranks restores onto 2 or 1 (elastic scale-down), and JAX's from 8
devices onto 4.

:func:`restore` places the state on one device (the card unless the
caller asks for the CPU) or, given ``shardings``, as DTensors on the
target mesh; :func:`restore_into` copies a checkpoint into a live
state's tensors in place (each rank its local shard of a DTensor leaf),
which keeps a model module and its cached bf16 copies valid.

:class:`AsyncCheckpointer` copies the state to the host on the caller's
thread (the gather of a sharded state included) and does the file work
on a background thread, so the train loop does not wait on the disk; an
error of the writer surfaces on the next ``wait()``.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.pspec import tree_items, tree_map
from repro_torch.train.optimizer import TrainState, param_tree

_SEP = "."


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}{_SEP}{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}{_SEP}{i}", v)
        elif node is None:
            flat[prefix + f"{_SEP}__none__"] = np.zeros(0)
        else:
            flat[prefix] = np.asarray(node)

    rec("", tree)
    return flat


def _tree_template(tree):
    """JSON-serialisable structure descriptor."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _tree_template(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_tree_template(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


def _rebuild(template, flat, prefix=""):
    kind = template["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, flat, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in template["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, flat, f"{prefix}{_SEP}{i}")
               for i, v in enumerate(template["items"])]
        return seq if kind == "list" else tuple(seq)
    if kind == "none":
        return None
    return flat[prefix]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded(state: "TrainState | dict") -> bool:
    """Whether any leaf of ``state`` is a DTensor (then saving is
    collective)."""
    if isinstance(state, dict):
        return False
    return _is_dtensor(state.step) or any(
        _is_dtensor(t) for tree in (param_tree(state.params), state.mu,
                                    state.nu) for _, t in tree_items(tree))


def _to_host(x) -> np.ndarray:
    """A host copy: a CPU tensor too is copied, since the optimizer writes
    the parameters in place while the async writer is still saving.  A
    DTensor is gathered first (collective)."""
    if _is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _writer() -> bool:
    """Whether this process writes files: rank 0 of the group, or the one
    process outside a group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def host_tree(state: TrainState) -> dict:
    """The state as the JAX package's host tree: ``mu``, ``nu``, ``params``
    and ``step`` (keys sorted, as ``jax.tree.map`` rebuilds a dict), each
    leaf a numpy array.  Collective when a leaf is a DTensor: every rank
    of its mesh gathers it, in the same leaf order."""
    return tree_map(_to_host, {"step": state.step,
                               "params": param_tree(state.params),
                               "mu": state.mu, "nu": state.nu})


def save(path: str, state: "TrainState | dict",
         extra: dict | None = None) -> None:
    """Write ``state`` (a :class:`TrainState` or a :func:`host_tree`) to
    ``path``.  With DTensor leaves it is collective: every rank gathers,
    rank 0 writes, and all wait at a barrier until ``COMMITTED`` exists."""
    sharded = _sharded(state)
    host = state if isinstance(state, dict) else host_tree(state)
    if sharded and not _writer():
        _barrier()
        return
    try:
        _write(path, host, extra)
    finally:
        if sharded:          # the other ranks wait here even on an error
            _barrier()


def _write(path: str, host: dict, extra: dict | None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(host)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    manifest = {
        "template": _tree_template(host),
        "step": int(host["step"]),
        "extra": extra or {},
        "time": time.time(),
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # atomic-ish completion marker (crash-consistent restore)
    with open(os.path.join(path, "COMMITTED"), "w") as f:
        f.write("ok")


def latest_committed(root: str) -> str | None:
    """Most recent committed checkpoint dir under ``root`` (step_N dirs)."""
    if not os.path.isdir(root):
        return None
    cands = []
    for d in os.listdir(root):
        full = os.path.join(root, d)
        if os.path.exists(os.path.join(full, "COMMITTED")):
            try:
                cands.append((int(d.split("_")[-1]), full))
            except ValueError:
                continue
    return max(cands)[1] if cands else None


def _place(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``full`` (this rank's copy of the whole array) as a DTensor with
    ``placements`` on the runtime ``mesh``; each rank keeps its own shard
    of its own copy, so nothing moves between ranks."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full.to(mesh.device_type), mesh, placements,
                             src_data_rank=None)


def _sharding_items(shardings: TrainState) -> dict:
    """The dotted names of a ``TrainState`` of shardings, as in the
    checkpoint's ``arrays.npz``."""
    out = {"step": shardings.step}
    for top in ("params", "mu", "nu"):
        out.update({f"{top}{_SEP}{n}": s
                    for n, s in tree_items(getattr(shardings, top))})
    return out


def restore(path: str, shardings: TrainState | None = None,
            device: "str | torch.device | None" = None
            ) -> tuple[TrainState, dict]:
    """The state at ``path``, with ``params``, ``mu`` and ``nu`` as trees
    of tensors; and the ``extra`` the writer passed.

    Without ``shardings``: each array goes to ``device`` (the card by
    default) as it is read.  With ``shardings``, a ``TrainState``-shaped
    tree of ``NamedSharding`` on a runtime mesh (the TARGET mesh, elastic
    restore): every leaf is a DTensor with those placements; each rank
    reads the arrays and keeps its own shards (ranks outside the mesh
    hold empty ones), and ``device`` is unused.  Every rank of the group
    calls it."""
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if shardings is None:
        dev = resolve_device(device)
        place = lambda name, a: torch.from_numpy(a).to(dev)
    else:
        by_name = _sharding_items(shardings)
        place = lambda name, a: _place(torch.from_numpy(a),
                                       by_name[name].mesh,
                                       by_name[name].placements())
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: place(k, z[k]) for k in z.files}
    tree = _rebuild(manifest["template"], flat)
    state = TrainState(step=tree["step"], params=tree["params"],
                       mu=tree["mu"], nu=tree["nu"])
    return state, manifest["extra"]


def _stored_shape(z, name: str) -> tuple:
    """The shape of array ``name`` of an open ``.npz``, from its header
    alone."""
    with z.zip.open(name + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return read(f)[0]


def restore_into(path: str, state: TrainState) -> tuple[TrainState, dict]:
    """Copy the checkpoint at ``path`` into ``state``'s own tensors, in
    place under ``torch.no_grad()``: the parameters (a module keeps its
    modules and its ``nn.Parameter`` leaves, and each copy bumps
    ``_version``, so cached bf16 copies are remade), ``mu`` and ``nu``.
    Returns the state holding them and the checkpoint's step, on the
    state's device (with the state's placements where ``step`` is a
    DTensor), and the ``extra`` the writer passed.  Each array is copied
    to its leaf as it is read; into a DTensor leaf, each rank copies its
    own local shard (every rank of the group calls it then).  Raises
    ``ValueError``, before any copy, unless the checkpoint holds exactly
    the state's leaves at their (global) shapes."""
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    live = {f"{top}{_SEP}{n}": t for top, tree in (
        ("params", param_tree(state.params)), ("mu", state.mu),
        ("nu", state.nu)) for n, t in tree_items(tree)}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        if set(z.files) != set(live) | {"step"}:
            raise ValueError(
                f"{path}: the checkpoint's leaves are not the state's: "
                f"{sorted(set(z.files) ^ (set(live) | {'step'}))[:6]}")
        for name, leaf in live.items():      # every shape before any copy
            shape = _stored_shape(z, name)
            if shape != tuple(leaf.shape):
                raise ValueError(f"{path}: {name} is {shape} in the "
                                 f"checkpoint, {tuple(leaf.shape)} live")
        with torch.no_grad():
            for name, leaf in live.items():
                full = torch.from_numpy(z[name])
                if _is_dtensor(leaf):
                    leaf.to_local().copy_(_place(
                        full, leaf.device_mesh, leaf.placements).to_local())
                else:
                    leaf.copy_(full)
        step = torch.from_numpy(z["step"])
        step = (_place(step, state.step.device_mesh, state.step.placements)
                if _is_dtensor(state.step) else step.to(state.step.device))
    return TrainState(step=step, params=state.params, mu=state.mu,
                      nu=state.nu), manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer: snapshot on caller thread, I/O async.
    ``log`` holds one entry a save: its path, bytes, the caller's
    snapshot seconds and the writer's seconds (set when it ends).

    A state with DTensor leaves is gathered on the caller's thread on
    every rank (collective); rank 0 alone writes, and every rank waits at
    a barrier in the next :meth:`wait`, so after it the checkpoint is
    committed for all of them."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        self.log: list[dict] = []
        self._barrier_due = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_due:
            self._barrier_due = False
            _barrier()
        if self.last_error is not None:
            raise self.last_error

    def save(self, state: TrainState, extra: dict | None = None):
        self.wait()   # one in flight at a time (double buffer)
        t0 = time.perf_counter()
        sharded = _sharded(state)
        host = host_tree(state)
        step = int(host["step"])
        path = os.path.join(self.root, f"step_{step}")
        entry = {"path": path, "step": step,
                 "bytes": sum(a.nbytes for a in _flatten(host).values()),
                 "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.log.append(entry)
        self._barrier_due = sharded
        if sharded and not _writer():
            return path

        def work():
            t1 = time.perf_counter()
            try:
                _write(path, host, extra)
                self._gc()
            except Exception as e:   # surfaced on next wait()
                self.last_error = e
            entry["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return path

    def _gc(self):
        dirs = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, "COMMITTED")):
                dirs.append((int(d.split("_")[1]), d))
        for _, d in sorted(dirs)[:-self.keep]:
            full = os.path.join(self.root, d)
            for f in os.listdir(full):
                os.remove(os.path.join(full, f))
            os.rmdir(full)
