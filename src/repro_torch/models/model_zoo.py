"""Model registry (port of ``repro.models.model_zoo``): a uniform API over
the ten architectures -- the SSM family (RWKV6), the hybrid family
(Zamba2: Mamba2 and a shared attention block), the dense, VLM and MoE
families (the transformer, with MLA for DeepSeek-V2) and the audio
family (the Whisper encoder-decoder).

    zoo    = get_model(cfg)
    defs   = zoo.param_defs(cfg)                         # ParamDef tree
    params = zoo.build(cfg, pspec.init_params(defs, gen, device))
    loss   = zoo.loss_fn(cfg, params, batch)             # train
    lg, c, _ = zoo.forward(cfg, params, batch, mode=..., cache=c)
    cache  = zoo.init_cache(cfg, batch, max_len, device)
    batch  = input_specs(cfg, shape)                     # meta tensors
    cache  = abstract_cache(cfg, shape)                  # meta tensors
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, Family, ShapeCfg
from repro_torch.distributed import pspec
from repro_torch.models import mamba2, moe, rwkv, transformer, whisper


@dataclasses.dataclass(frozen=True)
class Zoo:
    param_defs: Callable
    loss_fn: Callable
    forward: Callable
    init_cache: Callable
    build: Callable


def get_model(cfg: ArchConfig) -> Zoo:
    if cfg.family == Family.SSM:
        return Zoo(rwkv.param_defs, rwkv.loss_fn, rwkv.forward,
                   rwkv.init_cache, rwkv.RWKV6)
    if cfg.family == Family.HYBRID:
        return Zoo(mamba2.param_defs, mamba2.loss_fn, mamba2.forward,
                   mamba2.init_cache, mamba2.Zamba2)
    if cfg.family == Family.AUDIO:
        return Zoo(whisper.param_defs, whisper.loss_fn, whisper.forward,
                   whisper.init_cache, whisper.Whisper)
    return Zoo(transformer.param_defs, transformer.loss_fn,
               transformer.forward, transformer.init_cache,
               transformer.Transformer)


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total (or routing-active) parameter count from the ParamDef tree
    (nothing allocated): ``active_only`` leaves out the experts a token
    is not routed to, pad experts included, on every MoE layer."""
    total = pspec.param_count(get_model(cfg).param_defs(cfg))
    if active_only and cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        n_moe_layers = cfg.n_layers - m.first_dense_layers
        total -= (moe.padded_experts(m) - m.top_k) * per_expert * n_moe_layers
    return total


# ---------------------------------------------------------------------------
# input specs (meta tensors -- no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict[str, Any]:
    """Abstract inputs for a (train | prefill | decode) step: ``meta``
    tensors of JAX's shapes and dtypes.  Decode batches carry ONE new
    token; the cache of ``shape.seq_len`` is :func:`abstract_cache`."""
    B = shape.global_batch
    meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
    if shape.kind == "decode":
        T = 1
    elif cfg.family == Family.AUDIO:
        T = max(shape.seq_len // cfg.dec_ratio, 8)   # decoder text length
    elif cfg.family == Family.VLM:
        T = shape.seq_len - cfg.n_image_tokens       # text after the prefix
    else:
        T = shape.seq_len
    batch: dict[str, Any] = {"tokens": meta((B, T), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = meta((B, T), torch.int32)
    if cfg.family == Family.AUDIO and shape.kind != "decode":
        batch["frames"] = meta((B, shape.seq_len, cfg.d_model),
                               torch.bfloat16)
    if cfg.family == Family.VLM and shape.kind != "decode":
        batch["img_embeds"] = meta((B, cfg.n_image_tokens, cfg.d_model),
                                   torch.bfloat16)
    return batch


def _jax_lengths(tree):
    """The port's host cache lengths as JAX's leaves: a ``len`` beside
    stacked buffers (``k`` or ``c_kv``) is JAX's per-layer (n,) int32, any
    other ``len`` (Whisper's top-level one) a () int32."""
    if not isinstance(tree, dict):
        if isinstance(tree, (list, tuple)):
            return type(tree)(_jax_lengths(t) for t in tree)
        return tree
    out = {k: _jax_lengths(v) for k, v in tree.items()}
    if "len" in tree and isinstance(tree["len"], int):
        stacked = tree.get("k", tree.get("c_kv"))
        shape = () if stacked is None else (stacked.shape[0],)
        out["len"] = torch.empty(shape, dtype=torch.int32, device="meta")
    return out


def abstract_cache(cfg: ArchConfig, shape: ShapeCfg):
    """The decode cache of ``shape.seq_len`` positions as ``meta``
    tensors: the family's own ``init_cache`` run on ``meta``, with each
    host length (the port keeps one int a stack) given JAX's leaf, so the
    tree's shapes and dtypes are JAX's ``abstract_cache``'s."""
    from repro_torch.device import on_meta
    with on_meta():
        cache = get_model(cfg).init_cache(cfg, shape.global_batch,
                                          shape.seq_len)
    return _jax_lengths(cache)


def host_lengths(cache, length: int):
    """An abstract (or JAX-shaped) cache with every ``len`` leaf set to the
    host integer ``length``, the form the port's steps take."""
    if isinstance(cache, dict):
        return {k: (length if k == "len" else host_lengths(v, length))
                for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(host_lengths(c, length) for c in cache)
    return cache


def concrete_batch(cfg: ArchConfig, shape: ShapeCfg, seed: int = 0,
                   device: "str | torch.device | None" = None) -> dict:
    """A materialised random batch on ``device`` (the card by default):
    JAX's draws from ``numpy.random.default_rng(seed)`` in the same order
    (token ids in [0, vocab), floats normal, cast from f32)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            arr = rng.integers(0, cfg.vocab, size=s.shape).astype(np.int32)
        else:
            arr = rng.normal(size=s.shape).astype(np.float32)
        out[name] = torch.from_numpy(arr).to(device=dev, dtype=s.dtype)
    return out
