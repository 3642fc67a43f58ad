"""Which modules the benchmark may load, compared by whole top-level
name (the part before the first dot): ``repro_torch`` begins with
``repro`` and is the program, ``repro`` is the JAX reference package."""
from __future__ import annotations

import ast
import pathlib
from typing import Iterable

#: never loaded by a benchmark run: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: the program, which the reference may not import
PROGRAM = "repro_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def foreign(modules: Iterable[str]) -> list[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(m for m in modules if top(m) in FORBIDDEN)


def imported_tops(path: pathlib.Path) -> set[str]:
    """Top-level names of the absolute imports of one source file."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top(node.module))
    return out
