"""A configuration's model: trained by the reference trainer on the
configuration's dataset on a checkout's first run, then loaded from
``portbench/.cache/models/``, keyed by the configuration's contents and
the reference's sources."""
from __future__ import annotations

import hashlib
import json
import os
import pathlib

from .cells import BENCH
from .ref import flows, trainer, windows

CACHE = BENCH / ".cache"
_KEYED = ("flows.py", "windows.py", "trainer.py")


def n_windows(config: dict) -> int:
    return len(config["partition_sizes"])


def window_width(config: dict) -> int:
    """W: the widest window the dataset's lengths give."""
    lo, hi = flows.length_range(config["dataset"])
    return windows.max_window(lo, hi, n_windows(config))


def train(config: dict) -> trainer.Model:
    ds = flows.make_training_set(config["dataset"])
    tr, _ = ds.split(config["split"]["frac"], config["split"]["seed"])
    P = n_windows(config)
    X = windows.all_features(windows.window_packets(
        tr.packets, tr.lengths, P, window_width(config)))
    return trainer.train_model(
        X, tr.labels, partition_sizes=config["partition_sizes"],
        k=config["k"], n_classes=tr.n_classes,
        min_samples_subtree=config["min_samples_subtree"],
        min_samples_leaf=config["min_samples_leaf"],
        max_bins=config["max_bins"])


def cache_path(config: dict) -> pathlib.Path:
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode())
    for name in _KEYED:
        h.update((BENCH / "ref" / name).read_bytes())
    return CACHE / "models" / f"{config['name']}-{h.hexdigest()[:16]}.npz"


def load_or_train(config: dict) -> tuple[trainer.Model, bool]:
    """``(model, trained)``: ``trained`` when no cached model was found."""
    path = cache_path(config)
    if path.exists():
        return trainer.Model.load(path), False
    model = train(config)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + f".{os.getpid()}.tmp.npz")
    model.save(tmp)
    os.replace(tmp, path)
    return model, True
