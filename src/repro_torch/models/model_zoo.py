"""Model registry (port of ``repro.models.model_zoo``): a uniform API over
the families the port serves -- the SSM family (RWKV6), and the dense and
VLM families (the transformer).

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
from repro_torch.models import rwkv, transformer

#: the ROADMAP item that ports each family still missing
NOT_PORTED = {
    Family.MOE: "ROADMAP A.11 (MoE and MLA families)",
    Family.AUDIO: "ROADMAP A.11 (Whisper family)",
    Family.HYBRID: "ROADMAP A.11 (Mamba2/Zamba2 family)",
}


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
    if cfg.family in (Family.DENSE, Family.VLM):
        return Zoo(transformer.param_defs, transformer.loss_fn,
                   transformer.forward, transformer.init_cache,
                   transformer.Transformer)
    raise NotImplementedError(f"{cfg.family.value} family ({cfg.arch_id}) "
                              f"is not ported yet: {NOT_PORTED[cfg.family]}")


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total parameter count from the ParamDef tree (nothing allocated).
    ``active_only`` differs from the total only for MoE, not ported."""
    del active_only
    return pspec.param_count(get_model(cfg).param_defs(cfg))
