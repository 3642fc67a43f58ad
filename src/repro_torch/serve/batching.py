"""Continuous batching over a fixed slot pool (port of
``repro.serve.batching``).

A switch supports millions of flows with a FIXED register pool,
time-sharing state across flows; this server supports an open request
stream with a FIXED pool of B cache slots, admitting new requests into
freed slots every tick.

Per engine tick:
  1. admit: pop queued requests into free slots (per-slot prefill);
  2. decode: one decode step for each live slot;
  3. retire: slots whose request hit EOS/max_new free their state.

As in the JAX engine, each slot holds its own batch-1 cache and is
decoded on its own (no cross-slot batching yet).  Each sampled token is
read back to the host, which is what a server streaming tokens does.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    eos: int = -1
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    ticks: int = 0
    admitted: int = 0
    completed: int = 0
    decode_tokens: int = 0
    slot_occupancy: list = dataclasses.field(default_factory=list)


class ContinuousBatcher:
    """The serving engine over one device (``device=None``: the card).

    ``params`` is the model (``model_zoo.get_model(cfg).build(...)``: an
    RWKV6, a Zamba2, or a dense, VLM or MoE transformer, MLA included)
    and must live on ``device``.  Each slot keeps the family's own cache
    (RWKV6's recurrent state, whose time-mix runs the ``chunk_scan``
    kernel on the card; Zamba2's conv tails and SSM states, its Mamba2
    layers on the same kernel in the GLA form, and its shared block's KV
    caches; the transformer's KV cache of ``max_len`` positions, or MLA's
    latent cache).  As in JAX there is no audio path: an
    encoder-decoder is served through ``serve_step``'s prefill with
    frames and its decode step.
    """

    def __init__(self, cfg: ArchConfig, params, *, slots: int,
                 max_len: int, temperature: float = 0.0, seed: int = 0,
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        zoo = model_zoo.get_model(cfg)
        # one cache per slot (batch=1) -> admission never reshapes others
        self.caches = [zoo.init_cache(cfg, 1, max_len, self.device)
                       for _ in range(slots)]
        self.live: list[Request | None] = [None] * slots
        self.last_tok = np.zeros((slots, 1), np.int32)
        self.queue: deque[Request] = deque()
        self.prefill = make_prefill_step(cfg)
        self.decode = make_decode_step(cfg, temperature)
        self.zoo = zoo
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = EngineStats()

    def submit(self, req: Request):
        self.queue.append(req)

    # -- engine tick --------------------------------------------------------
    def tick(self):
        self._admit()
        self._decode_all()
        self._retire()
        self.stats.ticks += 1
        self.stats.slot_occupancy.append(
            sum(r is not None for r in self.live))

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(toks, np.int32)).to(
            self.device)

    def _admit(self):
        for s in range(self.slots):
            if self.live[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            cache = self.zoo.init_cache(self.cfg, 1, self.max_len,
                                        self.device)
            toks = self._tokens(np.asarray(req.prompt, np.int32)[None])
            lg, cache = self.prefill(self.params, {"tokens": toks}, cache)
            nxt = int(torch.argmax(lg[0, -1]))
            self.caches[s] = cache
            self.live[s] = req
            req.out.append(nxt)
            self.last_tok[s, 0] = nxt
            self.stats.admitted += 1

    def _decode_all(self):
        for s in range(self.slots):
            req = self.live[s]
            if req is None or req.done:
                continue
            nxt, cache = self.decode(
                self.params, self._tokens(self.last_tok[s:s + 1]),
                self.caches[s], self.rng)
            self.caches[s] = cache
            tok = int(nxt[0, 0])
            req.out.append(tok)
            self.last_tok[s, 0] = tok
            self.stats.decode_tokens += 1

    def _retire(self):
        for s in range(self.slots):
            req = self.live[s]
            if req is None:
                continue
            if (len(req.out) >= req.max_new
                    or (req.eos >= 0 and req.out and req.out[-1] == req.eos)):
                req.done = True
                self.live[s] = None      # register reuse: slot freed
                self.stats.completed += 1

    def run_until_drained(self, max_ticks: int = 1000) -> EngineStats:
        while (self.queue or any(self.live)) and self.stats.ticks < max_ticks:
            self.tick()
        return self.stats
