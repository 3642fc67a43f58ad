"""The comparison that decides ``correct``: every flow of the sampled
timed calls against the reference's walk of the same flows.

A flow is wrong when its label, its recirculation count or its exit
partition differs from the reference's; a call that returns another
number of flows than it was given counts all of them wrong.  The limit
is 0 wrong flows: the verdicts are integers the model defines exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .ref.walk import Walk


@dataclasses.dataclass
class Kept:
    """One sampled call: its index in the window, the batch it was
    given and the verdicts it returned (host arrays)."""
    call: int
    batch: int
    labels: np.ndarray
    recircs: np.ndarray
    exit_p: np.ndarray


def compare(kept: list[Kept], ref: Walk, rows: list[np.ndarray]) -> dict:
    """``{number: {"value": v, "max"|"min": limit}}``."""
    wrong = compared = 0
    for k in kept:
        r = rows[k.batch]
        got = (k.labels, k.recircs, k.exit_p)
        if any(np.shape(g) != r.shape for g in got):
            wrong += r.size
        else:
            bad = ((k.labels != ref.labels[r]) | (k.recircs != ref.recircs[r])
                   | (k.exit_p != ref.exit_p[r]))
            wrong += int(np.count_nonzero(bad))
        compared += r.size
    return {"wrong_flows": {"value": wrong, "max": 0},
            "flows_compared": {"value": compared, "min": 1}}


def passes(numbers: dict) -> bool:
    return all(("max" not in n or n["value"] <= n["max"])
               and ("min" not in n or n["value"] >= n["min"])
               for n in numbers.values())


def lines(numbers: dict) -> list[str]:
    """One line a number, its value beside its limit."""
    out = []
    for name, n in numbers.items():
        lim = f"<= {n['max']}" if "max" in n else f">= {n['min']}"
        out.append(f"check {name} = {n['value']} (limit {lim})")
    return out
