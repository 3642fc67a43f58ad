"""RWKV6 "Finch" (arXiv:2404.05892), port of ``repro.models.rwkv``:
attention-free decoder with data-dependent per-channel decay, executed
through the chunked linear-recurrence kernel (``kernels.ops.chunk_scan``,
bonus form).

The parameters are an :class:`RWKV6` module whose names follow the JAX
parameter tree (``embed``, ``layers.tm.w_r``, ``layers.cm.wk``,
``ln_f``, ``head``, ...), each layer parameter stacked over the layers as
in JAX, so a converted JAX tree loads one to one
(``convert.rwkv_params_from_arrays``).  A Python loop over the layers
takes the place of ``scan_layers``; as in JAX, a training forward under
autograd rematerialises each layer (one checkpoint region, no policy).

The JAX dtype steps are kept: activations in bf16, each weight cast to
bf16 at its product, the decay ``exp(-exp(wlog))`` and the recurrence in
f32.  Outside autograd the bf16 copies of the f32 weights are made once
and reused (:meth:`~repro_torch.models.layers.LMModule.bf16`), which
gives the same numbers as casting at every call.

Decode state per layer: time-mix token-shift (B, D), channel-mix
token-shift (B, D), and the recurrent matrix state (B*H, hd, hd) -- O(1)
in context length.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.pspec import ParamDef, stack_tree
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import COMPUTE_DTYPE

LORA_RANK = 32
DECAY_LORA_RANK = 64
_MIX = ("r", "k", "v", "w", "g")


def _head_dims(cfg: ArchConfig) -> tuple[int, int]:
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def _layer_defs(cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    H, hd = _head_dims(cfg)
    tm: dict[str, ParamDef] = {
        "mu_x": ParamDef((D,), ("embed",), init="zeros"),
        "w0": ParamDef((D,), ("embed",), init="zeros"),
        "decay_a": ParamDef((D, DECAY_LORA_RANK), ("embed", "lora"),
                            scale=0.01),
        "decay_b": ParamDef((DECAY_LORA_RANK, D), ("lora", "embed"),
                            scale=0.01),
        "bonus": ParamDef((H, hd), ("heads", "head_dim"), init="zeros"),
        "wo": ParamDef((D, D), ("heads", "embed")),
    }
    for m in _MIX:
        tm[f"mu_{m}"] = ParamDef((D,), ("embed",), init="zeros")
        tm[f"lora_a_{m}"] = ParamDef((D, LORA_RANK), ("embed", "lora"),
                                     scale=0.01)
        tm[f"lora_b_{m}"] = ParamDef((LORA_RANK, D), ("lora", "embed"),
                                     scale=0.01)
        if m != "w":
            tm[f"w_{m}"] = ParamDef((D, D), ("embed", "heads"))
    cm = {
        "mu_k": ParamDef((D,), ("embed",), init="zeros"),
        "mu_r": ParamDef((D,), ("embed",), init="zeros"),
        "wk": ParamDef((D, F), ("embed", "mlp")),
        "wv": ParamDef((F, D), ("mlp", "embed")),
        "wr": ParamDef((D, D), ("embed", "heads")),
    }
    return {"ln1": L.rmsnorm_def(D), "tm": tm,
            "ln2": L.rmsnorm_def(D), "cm": cm}


def param_defs(cfg: ArchConfig) -> dict:
    return {
        "embed": L.embed_defs(cfg.vocab, cfg.d_model),
        "layers": stack_tree(_layer_defs(cfg), cfg.n_layers),
        "ln_f": L.rmsnorm_def(cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1}; position 0 uses the carried state (or 0)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


class TimeMix(L.ParamGroup):
    """RWKV6 time-mix of one layer, with the stacked ``layers.tm.*``."""

    def forward(self, model: "RWKV6", i: int, x: torch.Tensor,
                state: dict | None, impl: str | None):
        """state: None (train) or {shift (B, D), S (B*H, dk, dv)}."""
        cfg = model.cfg
        B, T, D = x.shape
        H, hd = _head_dims(cfg)
        w = lambda name: model.bf16(self, name, i)
        xc = x.to(COMPUTE_DTYPE)
        prev = None if state is None else state["shift"]
        xs_delta = _shift(xc, prev) - xc
        xxx = xc + xs_delta * w("mu_x")

        def ddlerp(m):
            lora = torch.tanh(xxx @ w(f"lora_a_{m}")) @ w(f"lora_b_{m}")
            return xc + xs_delta * (w(f"mu_{m}") + lora)

        r = ddlerp("r") @ w("w_r")
        k = ddlerp("k") @ w("w_k")
        v = ddlerp("v") @ w("w_v")
        g = ddlerp("g") @ w("w_g")
        wlog = (self.w0[i].float()
                + (torch.tanh(ddlerp("w") @ w("decay_a"))
                   @ w("decay_b")).float())
        decay = torch.exp(-torch.exp(wlog))              # (B, T, D) in (0,1)

        s0 = None if state is None else state["S"]
        o, s_new = _heads_scan(r, k, v, decay, self.bonus[i], s0, hd,
                               cfg.ssm.chunk, impl)
        o = o * L.silu(g)
        out = (o.to(COMPUTE_DTYPE) @ w("wo")).to(x.dtype)
        new_state = None
        if state is not None:
            new_state = {"shift": xc[:, -1, :], "S": s_new}
        return out, new_state


def _heads_scan(r, k, v, decay, bonus, s0, hd: int, chunk: int,
                impl: str | None):
    """The heads' recurrence: (B, T, D) inputs split into (B*H, T, hd)
    heads, ``chunk_scan``, and the head-wise GroupNorm of its output;
    returns (o (B, T, D), the new state).  On DTensors every (batch,
    head) block scans on its own (``layers.per_shard``), so no
    collective is needed where the heads split at head boundaries; with
    a state (decode) the heads stay whole on each chip, the state's
    flattened (B*H) rows split with the batch only."""
    H = r.shape[-1] // hd

    def core(r, k, v, decay, bonus, s0=None):
        B, T, D = r.shape
        h = D // hd

        def heads(t):  # (B, T, D) -> (B*h, T, hd)
            return (t.reshape(B, T, h, hd).transpose(1, 2)
                    .reshape(B * h, T, hd))

        o, s_new = ops.chunk_scan(
            heads(r).float(), heads(k).float(), heads(v).float(),
            heads(decay),
            bonus=bonus.float()[None].expand(B, h, hd).reshape(B * h, hd),
            state=s0, chunk=chunk, impl=impl)
        o = o.reshape(B, h, T, hd).transpose(1, 2).reshape(B, T, D)
        return L.groupnorm(o, h, eps=64e-5), s_new

    dims = [(0, 2)] * 4 + [(None, 0)]
    if s0 is None:
        return L.per_shard(lambda *a: core(*a)[0], (r, k, v, decay, bonus),
                           dims, [(0, 2)], H), None
    return L.per_shard(core, (r, k, v, decay, bonus, s0),
                       dims + [(0, None)], [(0, 2), (0, None)], H,
                       whole_heads=True)


class ChannelMix(L.ParamGroup):
    """RWKV6 channel-mix of one layer, with the stacked ``layers.cm.*``."""

    def forward(self, model: "RWKV6", i: int, x: torch.Tensor,
                state: dict | None):
        w = lambda name: model.bf16(self, name, i)
        xc = x.to(COMPUTE_DTYPE)
        prev = None if state is None else state["shift"]
        xs_delta = _shift(xc, prev) - xc
        xk = xc + xs_delta * w("mu_k")
        xr = xc + xs_delta * w("mu_r")
        k = L.shard(torch.square(torch.relu(xk @ w("wk"))), L.BATCH_AXES,
                    None, "model")
        kv = k @ w("wv")
        out = torch.sigmoid(xr @ w("wr")) * kv
        new_state = None if state is None else {"shift": xc[:, -1, :]}
        return out.to(x.dtype), new_state


class _Layers(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.tm = TimeMix(tree["tm"])
        self.cm = ChannelMix(tree["cm"])


class RWKV6(L.LMModule):
    """The model's parameters and its forward pass.

    Built from a tree of tensors shaped as :func:`param_defs` (the
    tensors become the parameters, not copies).  ``forward(batch, mode,
    cache, impl)`` returns ``(logits (B, T, V) bf16, new_cache, aux)``
    like the JAX ``forward``; ``impl`` goes to ``ops.chunk_scan`` (None:
    the kernel on the card, the plain version on the CPU; "ref": the
    plain version anywhere).
    """

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, param_defs(cfg), tree)
        self.embed = nn.Parameter(tree["embed"])
        self.layers = _Layers(tree["layers"])
        self.ln_f = nn.Parameter(tree["ln_f"])
        self.head = nn.Parameter(tree["head"])

    def forward(self, batch: dict, *, mode: str = "train",
                cache: dict | None = None, impl: str | None = None):
        cfg = self.cfg
        x = L.shard(L.embed(self.embed, batch["tokens"]), L.BATCH_AXES, None,
                    None)
        lay = self.layers
        new = None if cache is None else {"tm": {"shift": [], "S": []},
                                          "cm": {"shift": []}}

        def block(i, x, tm_state, cm_state):
            a, tm_new = lay.tm(self, i, L.rmsnorm(lay.ln1[i], x,
                                                  cfg.norm_eps),
                               tm_state, impl)
            x = x + a
            b, cm_new = lay.cm(self, i, L.rmsnorm(lay.ln2[i], x,
                                                  cfg.norm_eps), cm_state)
            return x + b, tm_new, cm_new

        if mode == "train" and L.records(x, *self.parameters()):
            block = L.remat(block)
        for i in range(cfg.n_layers):
            tm_state = None if cache is None else {
                "shift": cache["tm"]["shift"][i], "S": cache["tm"]["S"][i]}
            cm_state = None if cache is None else {
                "shift": cache["cm"]["shift"][i]}
            x, tm_new, cm_new = block(i, x, tm_state, cm_state)
            if new is not None:
                new["tm"]["shift"].append(tm_new["shift"])
                new["tm"]["S"].append(tm_new["S"])
                new["cm"]["shift"].append(cm_new["shift"])
        x = L.rmsnorm(self.ln_f, x, cfg.norm_eps)
        lg = L.logits(self.bf16(self, "head"), x, transpose=False)
        if new is not None:
            new = {"tm": {"shift": torch.stack(new["tm"]["shift"]),
                          "S": torch.stack(new["tm"]["S"])},
                   "cm": {"shift": torch.stack(new["cm"]["shift"])}}
        return lg, new, torch.zeros((), dtype=torch.float32,
                                    device=x.device)


def forward(cfg: ArchConfig, params: RWKV6, batch: dict, *,
            mode: str = "train", cache=None, impl: str | None = None):
    """The JAX signature: ``params`` is the :class:`RWKV6` module."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(batch, mode=mode, cache=cache, impl=impl)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> dict:
    """Recurrent state -- O(1) in ``max_len`` (the SSM long-context win).
    ``device=None`` means the card, as at every entry point."""
    from repro_torch.device import resolve_device
    del max_len
    dev = resolve_device(device)
    H, hd = _head_dims(cfg)
    Ln, D = cfg.n_layers, cfg.d_model
    return {
        "tm": {"shift": torch.zeros((Ln, batch, D), dtype=COMPUTE_DTYPE,
                                    device=dev),
               "S": torch.zeros((Ln, batch * H, hd, hd),
                                dtype=torch.float32, device=dev)},
        "cm": {"shift": torch.zeros((Ln, batch, D), dtype=COMPUTE_DTYPE,
                                    device=dev)},
    }


def loss_fn(cfg: ArchConfig, params: RWKV6, batch: dict) -> torch.Tensor:
    lg, _, _ = forward(cfg, params, batch, mode="train")
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return L.cross_entropy(lg[:, :-1], torch.clamp(labels[:, 1:], min=0),
                           mask[:, 1:])
