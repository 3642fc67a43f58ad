"""Analytic per-device memory accounting (port of
``repro.analysis.memory``): exact for state, modelled for activations.

The persistent state (parameter, optimizer, gradient and cache bytes) is
computed from the resolved shardings leaf by leaf; activations use JAX's
saved-residual formula of its remat policy, term for term.  The port's
train step runs the same remat (``models.transformer.set_remat``: each
layer recomputed in the backward, each blockwise step checkpointed, remat
off in the FSDP-2D train layout), so the formula describes the port's own
program; where the port keeps a layer's input and residual sum, the
formula counts three (B, T, D) tensors a layer, one more.  The budget is
judged against the H100's memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.distributed import pspec as pspec_lib

# torch.cuda.get_device_properties(0).total_memory of an "NVIDIA H100 80GB
# HBM3" (power limit 700 W), read on the card by chip_smoke.py phase dist
HBM_PER_CHIP = 85_017_493_504


def _sharded_bytes(abs_tree, spec_tree, mesh_sizes: dict[str, int]) -> int:
    """Exact per-device bytes of a tree of abstract tensors under a tree
    of specs (a spec at each leaf's place; ``None`` for replicated)."""
    total = 0

    def one(t, spec):
        nonlocal total
        shards = 1
        for entry in spec or ():
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            for a in axes:
                shards *= mesh_sizes.get(a, 1)
        total += math.prod(t.shape) * t.dtype.itemsize // max(shards, 1)

    pspec_lib.map_structure(one, abs_tree, spec_tree)
    return total


@dataclasses.dataclass
class MemoryBudget:
    params_bytes: int
    optimizer_bytes: int
    grads_bytes: int
    cache_bytes: int
    activation_bytes: int
    total_bytes: int
    fits: bool

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["total_gb"] = self.total_bytes / 1e9
        return d


def activation_estimate(cfg: ArchConfig, shape: ShapeCfg,
                        dp_shards: int, opt_layout: bool = False) -> int:
    """JAX's saved residuals under its per-layer remat policy: ~3 bf16
    tensors of (B_local, T, D) per layer (block input + attn_out +
    mlp_out), plus one live layer's working set.  Baseline: naive
    attention materialises f32 probs for the live layer.  Opt layout:
    batch sharded over ALL mesh axes (FSDP-2D), remat off (~10 saved
    tensors/layer), blockwise attention bounds the live set to one
    512-wide KV block.  The port's train step remats the same way."""
    if shape.kind == "decode":
        return 0
    B_local = max(shape.global_batch // dp_shards, 1)
    T = shape.seq_len
    per_layer = 10 if opt_layout else 3   # no-remat saves everything
    saved = per_layer * cfg.n_layers * B_local * T * cfg.d_model * 2
    if opt_layout:
        probs = 4 * B_local * cfg.n_heads * T * 512   # one KV block
    else:
        probs = 4 * B_local * cfg.n_heads * min(T, 4096) * T // 16
    return int(saved + probs)


def budget(cfg: ArchConfig, shape: ShapeCfg, mesh_sizes: dict[str, int],
           param_defs, cache_abs=None, cache_specs=None,
           train: bool = True, rules=None, param_dtype=None,
           capacity: int = HBM_PER_CHIP) -> MemoryBudget:
    """JAX's budget term for term; ``fits`` against ``capacity`` (the
    H100's memory by default)."""
    opt_layout = rules is not None
    specs = pspec_lib.resolve_specs(param_defs, mesh_sizes, rules)
    params_abs = pspec_lib.abstract_params(param_defs, dtype=param_dtype)
    pbytes = _sharded_bytes(params_abs, specs, mesh_sizes)
    opt = 2 * pbytes if train else 0
    grads = pbytes if train else 0
    cache = 0
    if cache_abs is not None:
        cache = _sharded_bytes(cache_abs, cache_specs, mesh_sizes)
    dp = mesh_sizes.get("pod", 1) * mesh_sizes.get("data", 1)
    if opt_layout and train:
        dp *= mesh_sizes.get("model", 1)   # FSDP-2D: batch on all axes
    act = activation_estimate(cfg, shape, dp, opt_layout) if train else 0
    total = pbytes + opt + grads + cache + act
    return MemoryBudget(
        params_bytes=pbytes, optimizer_bytes=opt, grads_bytes=grads,
        cache_bytes=cache, activation_bytes=act, total_bytes=total,
        fits=total <= capacity)
