"""Carry a model's engine tables across from the JAX package.

The JAX engine uploads a trained model as nine device arrays
(``repro.kernels.ops.DeviceTables``).  Handed over as numpy arrays, the
same nine arrays build an engine here, so both packages can run the very
same tables:

    arrays = {name: np.asarray(getattr(jax_dev, name))
              for name in jax_dev._fields}
    engine = Engine.from_tables(engine_tables_from_arrays(
        arrays, n_subtrees=S, n_partitions=P, n_classes=C, device="cuda"))

The same goes for a live server's mid-stream state: the ten fields of a
JAX ``repro.kernels.tick_step.TickState``, as numpy arrays, become the
port's :class:`~repro_torch.kernels.tick_step.TickState`
(:func:`tick_state_from_arrays`), so both packages can step the very
same state.

This module takes plain numpy, so it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inference import EngineTables
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import DEVICE_TABLE_DTYPES, DeviceTables
from repro_torch.kernels.tick_step import TickState


def engine_tables_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    n_subtrees: int,
    n_partitions: int,
    n_classes: int,
    device: "str | torch.device | None" = None,
) -> EngineTables:
    """Validate the nine ``DeviceTables`` arrays and upload them.

    Shapes must be consistent (``slot_*`` (S, k), ``thresholds``
    (S, k, T), ``leaf_lo``/``leaf_hi`` (S, L, k), ``leaf_action``/
    ``leaf_valid`` (S, L)) with S = ``n_subtrees``, and every array must
    already have the dtype the engine runs on (int32 or f32): a silent
    cast could change a threshold's bits.
    """
    missing = set(DEVICE_TABLE_DTYPES) - set(arrays)
    extra = set(arrays) - set(DEVICE_TABLE_DTYPES)
    if missing or extra:
        raise ValueError(f"need exactly the DeviceTables fields; missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    host = {name: np.asarray(arrays[name]) for name in DEVICE_TABLE_DTYPES}
    S, k, T = host["thresholds"].shape
    L = host["leaf_lo"].shape[1]
    shapes = {"slot_op": (S, k), "slot_field": (S, k), "slot_pred": (S, k),
              "slot_init": (S, k), "thresholds": (S, k, T),
              "leaf_lo": (S, L, k), "leaf_hi": (S, L, k),
              "leaf_action": (S, L), "leaf_valid": (S, L)}
    if S != n_subtrees:
        raise ValueError(f"tables hold {S} subtrees, n_subtrees={n_subtrees}")
    for name, dt in DEVICE_TABLE_DTYPES.items():
        a = host[name]
        want = np.dtype(str(dt).removeprefix("torch."))
        if a.shape != shapes[name] or a.dtype != want:
            raise ValueError(f"{name}: need {want} {shapes[name]}, got "
                             f"{a.dtype} {a.shape}")
    dev = resolve_device(device)
    tables = DeviceTables(**{name: torch.tensor(host[name], device=dev)
                             for name in DEVICE_TABLE_DTYPES})
    return EngineTables(dev=tables, n_subtrees=int(n_subtrees),
                        n_partitions=int(n_partitions),
                        n_classes=int(n_classes))


def tick_state_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    device: "str | torch.device | None" = None,
) -> TickState:
    """Validate the ten ``TickState`` arrays and upload them.

    ``acc`` must be f32 (N+1, k), ``seen`` int32 (N+1, k), ``bounds``
    int32 (N+1, P, 2) and the seven per-row fields int32 (N+1,), with
    one N+1 throughout.  No dtype is cast, as in
    :func:`engine_tables_from_arrays`.
    """
    fields = TickState._fields
    missing = set(fields) - set(arrays)
    extra = set(arrays) - set(fields)
    if missing or extra:
        raise ValueError(f"need exactly the TickState fields; missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    host = {name: np.asarray(arrays[name]) for name in fields}
    n1, k = host["acc"].shape
    P = host["bounds"].shape[1]
    for name in fields:
        a = host[name]
        want_dt = np.float32 if name == "acc" else np.int32
        want = ((n1, k) if name in ("acc", "seen")
                else (n1, P, 2) if name == "bounds" else (n1,))
        if a.shape != want or a.dtype != want_dt:
            raise ValueError(f"{name}: need {np.dtype(want_dt)} {want}, got "
                             f"{a.dtype} {a.shape}")
    dev = resolve_device(device)
    return TickState(**{name: torch.tensor(host[name], device=dev)
                        for name in fields})
