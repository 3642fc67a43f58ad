"""Decoder-only transformer, the dense/GQA family (tinyllama, minitron,
granite, stablelm) and the VLM backbone (paligemma prefix-LM); port of
``repro.models.transformer``.  The MoE and MLA branches of the JAX model
(``cfg.moe``, ``cfg.mla``, ``lead_layers``) are not ported: asking for
them raises naming ROADMAP A.11 (MoE and MLA families).

The parameters are a :class:`Transformer` module whose names follow the
JAX parameter tree (``embed``, ``layers.ln1``, ``layers.attn.wq``,
``layers.mlp.wg``, ``ln_f``, ``head``, ``img_proj``), each layer
parameter stacked over the layers as in JAX, so a converted JAX tree
loads one to one (``convert.transformer_params_from_arrays``).  A Python
loop over the layers takes the place of ``_scan_layers``; remat has no
counterpart (serving does not need it).

Modes, as in JAX (the attention is the same in all three; ``mode``
selects nothing else in the dense family):
  train   -- causal forward, next-token CE loss (``loss_fn``)
  prefill -- causal forward, filling a KV cache when one is given
  decode  -- T new tokens against an existing cache

The KV cache is ``{"layers": {"k", "v": (L, B, S, Hkv, Dh) bf16, "len":
int}}``: one host length for all layers, where JAX stacks an int32
``len`` per layer (see ``layers.attention_block``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.pspec import ParamDef, stack_tree
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnShape, COMPUTE_DTYPE

MODES = ("train", "prefill", "decode")
NOT_PORTED = "ROADMAP A.11 (MoE and MLA families)"


def _attn_shape(cfg: ArchConfig) -> AttnShape:
    return AttnShape(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: the MoE / MLA transformer is not ported yet: "
            f"{NOT_PORTED}")


def _layer_defs(cfg: ArchConfig) -> dict:
    return {"ln1": L.rmsnorm_def(cfg.d_model),
            "ln2": L.rmsnorm_def(cfg.d_model),
            "attn": L.attention_defs(cfg.d_model, _attn_shape(cfg)),
            "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act)}


def param_defs(cfg: ArchConfig) -> dict:
    _dense_only(cfg)
    defs: dict = {
        "embed": L.embed_defs(cfg.vocab, cfg.d_model),
        "layers": stack_tree(_layer_defs(cfg), cfg.n_layers),
        "ln_f": L.rmsnorm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    if cfg.n_image_tokens:
        # stub projection applied to precomputed patch embeddings
        defs["img_proj"] = ParamDef((cfg.d_model, cfg.d_model),
                                    ("embed", None))
    return defs


def _embed_scale(cfg: ArchConfig, dtype: torch.dtype) -> float | None:
    """The gemma convention: embeddings times sqrt(d_model) when the
    embeddings are tied or the model is PaliGemma.  Parity trap: JAX casts
    the factor to the activations' dtype first (``jnp.asarray(..,
    x.dtype)``), so in bf16 sqrt(2048) = 45.2548... multiplies as 45.25."""
    if cfg.arch_id.startswith("paligemma") or cfg.tie_embeddings:
        return float(torch.tensor(cfg.d_model ** 0.5, dtype=dtype))
    return None


class _Layers(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.attn = L.ParamGroup(tree["attn"])
        self.mlp = L.ParamGroup(tree["mlp"])


class Transformer(L.LMModule):
    """The model's parameters and its forward pass.

    Built from a tree of tensors shaped as :func:`param_defs` (the
    tensors become the parameters, not copies).  ``forward(batch, mode,
    cache)`` returns ``(logits (B, T, V) bf16, new_cache, aux)`` like the
    JAX ``forward``; ``aux`` is 0 (no router loss in the dense family).
    """

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, param_defs(cfg), tree)
        self.embed = nn.Parameter(tree["embed"])
        self.layers = _Layers(tree["layers"])
        self.ln_f = nn.Parameter(tree["ln_f"])
        self.head = nn.Parameter(tree["head"]) if "head" in tree else None
        self.img_proj = (nn.Parameter(tree["img_proj"])
                         if "img_proj" in tree else None)

    def forward(self, batch: dict, *, mode: str = "train",
                cache: dict | None = None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}; options: {MODES}")
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"])
        prefix_len = 0
        if cfg.n_image_tokens and "img_embeds" in batch:
            img = (batch["img_embeds"].to(COMPUTE_DTYPE)
                   @ self.bf16(self, "img_proj"))
            x = torch.cat([img, x], dim=1)
            prefix_len = cfg.n_image_tokens
        scale = _embed_scale(cfg, x.dtype)
        if scale is not None:
            x = x * scale
        lay = self.layers
        shape = _attn_shape(cfg)
        kv = None if cache is None else cache["layers"]
        for i in range(cfg.n_layers):
            layer_cache = None if kv is None else {
                "k": kv["k"][i], "v": kv["v"][i], "len": kv["len"]}
            attn = {n: self.bf16(lay.attn, n)[i]
                    for n in ("wq", "wk", "wv", "wo")}
            a, _ = L.attention_block(
                attn, L.rmsnorm(lay.ln1[i], x, cfg.norm_eps), shape=shape,
                rope_theta=cfg.rope_theta, prefix_len=prefix_len,
                window=cfg.sliding_window, cache=layer_cache)
            x = x + a
            ffn = {n: self.bf16(lay.mlp, n)[i] for n, _ in
                   lay.mlp.named_parameters()}
            x = x + L.mlp(ffn, L.rmsnorm(lay.ln2[i], x, cfg.norm_eps),
                          cfg.act)
        x = L.rmsnorm(self.ln_f, x, cfg.norm_eps)
        if cfg.tie_embeddings:
            lg = L.logits(self.bf16(self, "embed"), x, transpose=True)
        else:
            lg = L.logits(self.bf16(self, "head"), x, transpose=False)
        new_cache = None
        if kv is not None:
            # every layer wrote [len, len + T) of its own buffers in place
            new_cache = {"layers": {"k": kv["k"], "v": kv["v"],
                                    "len": kv["len"] + x.shape[1]}}
        return lg, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def forward(cfg: ArchConfig, params: Transformer, batch: dict, *,
            mode: str = "train", cache=None):
    """The JAX signature: ``params`` is the :class:`Transformer` module."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(batch, mode=mode, cache=cache)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> dict:
    """Stacked (L, batch, max_len, Hkv, Dh) bf16 KV buffers, length 0.
    ``device=None`` means the card, as at every entry point."""
    from repro_torch.device import resolve_device
    _dense_only(cfg)
    dev = resolve_device(device)
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {
        "k": torch.zeros(sh, dtype=L.COMPUTE_DTYPE, device=dev),
        "v": torch.zeros(sh, dtype=L.COMPUTE_DTYPE, device=dev),
        "len": 0}}


def loss_fn(cfg: ArchConfig, params: Transformer,
            batch: dict) -> torch.Tensor:
    lg, _, _ = forward(cfg, params, batch, mode="train")
    labels = batch["labels"]
    if cfg.n_image_tokens and "img_embeds" in batch:
        # loss only over text positions
        pad = torch.full((labels.shape[0], cfg.n_image_tokens), -1,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = (labels >= 0).float()
    return L.cross_entropy(lg[:, :-1], torch.clamp(labels[:, 1:], min=0),
                           mask[:, 1:])
