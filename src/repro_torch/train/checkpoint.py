"""Checkpoints with an async writer (port of ``repro.train.checkpoint``).

The files are the JAX package's: ``arrays.npz`` with one array per leaf
under its dotted path (``params.layers.attn.wq``, ``mu.embed``, ...,
``step``), ``manifest.json`` with the tree ``template``, ``step``,
``extra`` and ``time``, and the ``COMMITTED`` marker written last.  A
checkpoint that either package writes restores in the other, which is
the training state's cross-package path.

:func:`restore` places the state on one device (the card unless the
caller asks for the CPU); :func:`restore_into` copies a checkpoint into a
live state's tensors in place, which keeps a model module and its cached
bf16 copies valid; restoring onto a target mesh is part of the
multi-device half (ROADMAP A.11(f)).

:class:`AsyncCheckpointer` copies the state to the host on the caller's
thread and does the file work on a background thread, so the train loop
does not wait on the disk; an error of the writer surfaces on the next
``wait()``.
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


def _to_host(x) -> np.ndarray:
    """A host copy: a CPU tensor too is copied, since the optimizer writes
    the parameters in place while the async writer is still saving."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def host_tree(state: TrainState) -> dict:
    """The state as the JAX package's host tree: ``mu``, ``nu``, ``params``
    and ``step`` (keys sorted, as ``jax.tree.map`` rebuilds a dict), each
    leaf a numpy array."""
    return tree_map(_to_host, {"step": state.step,
                               "params": param_tree(state.params),
                               "mu": state.mu, "nu": state.nu})


def save(path: str, state: "TrainState | dict",
         extra: dict | None = None) -> None:
    """Write ``state`` (a :class:`TrainState` or a :func:`host_tree`) to
    ``path``."""
    os.makedirs(path, exist_ok=True)
    host = state if isinstance(state, dict) else host_tree(state)
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


def restore(path: str, device: "str | torch.device | None" = None
            ) -> tuple[TrainState, dict]:
    """The state at ``path`` on ``device`` (the card by default), with
    ``params``, ``mu`` and ``nu`` as trees of tensors; and the ``extra``
    the writer passed.  Each array goes to the device as it is read."""
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
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
    state's device, and the ``extra`` the writer passed.  Each array is
    copied to its leaf as it is read.  Raises ``ValueError``, before any
    copy, unless the checkpoint holds exactly the state's leaves at their
    shapes."""
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
                leaf.copy_(torch.from_numpy(z[name]))
        step = torch.from_numpy(z["step"]).to(state.step.device)
    return TrainState(step=step, params=state.params, mu=state.mu,
                      nu=state.nu), manifest["extra"]


class AsyncCheckpointer:
    """Background-thread writer: snapshot on caller thread, I/O async.
    ``log`` holds one entry a save: its path, bytes, the caller's
    snapshot seconds and the writer's seconds (set when it ends)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        self.log: list[dict] = []

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error

    def save(self, state: TrainState, extra: dict | None = None):
        self.wait()   # one in flight at a time (double buffer)
        t0 = time.perf_counter()
        host = host_tree(state)
        step = int(host["step"])
        path = os.path.join(self.root, f"step_{step}")
        entry = {"path": path, "step": step,
                 "bytes": sum(a.nbytes for a in _flatten(host).values()),
                 "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.log.append(entry)

        def work():
            t1 = time.perf_counter()
            try:
                save(path, host, extra)
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
