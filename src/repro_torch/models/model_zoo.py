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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig, Family
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
