"""Find a cell and everything it names by name: the configuration in
``BENCHMARK.json``'s ``configs`` (its file), the traffic mix in
``traffic/<name>.json`` and each per-layer metric's reader in
``metrics/<name>.py``.  Adding a configuration, a mix or a metric adds
files and entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    source: str


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(workload: str, bench: dict | None = None,
            root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``workload``; raises ``KeyError`` for a name
    ``BENCHMARK.json`` does not have."""
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic_path = BENCH / "traffic" / f"{entry['traffic']}.json"
    metric = lambda m: Metric(m["name"], m["unit"], m["source"])
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config_name=conf["name"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic_name=entry["traffic"],
        traffic=json.loads(traffic_path.read_text()),
        end_to_end=tuple(metric(m) for m in bench["end_to_end"]
                         if _applies(m, workload)),
        per_layer=tuple(metric(m) for m in bench["per_layer"]
                        if _applies(m, workload)))


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read(ctx) -> float | None``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
