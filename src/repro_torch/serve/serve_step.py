"""Serving steps (port of ``repro.serve.serve_step``): prefill, and
decode with greedy or temperature sampling.

The returned functions take the model (the port's parameters: an
``RWKV6``, a ``Zamba2``, a ``Transformer`` or a ``Whisper`` module; a
Whisper prefill's batch carries the ``frames``) where the JAX steps
take the parameter tree, and run under ``torch.no_grad``.  At
temperature > 0 the decode step samples with the ``torch.Generator`` it
is given, whose draws are not JAX's.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo
from repro_torch.models.layers import gathered


def make_prefill_step(cfg: ArchConfig) -> Callable:
    zoo = model_zoo.get_model(cfg)

    @torch.no_grad()
    def prefill(params, batch, cache):
        lg, cache, _ = zoo.forward(cfg, params, batch, mode="prefill",
                                   cache=cache)
        return lg[:, -1:], cache         # next-token logits only

    return prefill


def make_decode_step(cfg: ArchConfig, temperature: float = 0.0) -> Callable:
    zoo = model_zoo.get_model(cfg)

    @torch.no_grad()
    def decode(params, tokens, cache, generator=None):
        """tokens: (B, 1) last sampled tokens -> (next (B, 1) int32,
        cache)."""
        lg, cache, _ = zoo.forward(cfg, params, {"tokens": tokens},
                                   mode="decode", cache=cache)
        lg = lg[:, -1, :].float()
        if temperature > 0.0:
            probs = torch.softmax(lg / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            # DTensor logits (the dry run's sharded trace): the vocab
            # gathered first; DTensor's split argmax fails on a batch of
            # one in torch 2.11
            nxt = torch.argmax(gathered(lg, 1), dim=-1)
        return nxt[:, None].to(torch.int32), cache

    return decode
