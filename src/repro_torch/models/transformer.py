"""Decoder-only transformer, the dense/GQA family (tinyllama, minitron,
granite, stablelm), the MoE family (qwen2-moe, and deepseek-v2 with MLA)
and the VLM backbone (paligemma prefix-LM); port of
``repro.models.transformer``.

The parameters are a :class:`Transformer` module whose names follow the
JAX parameter tree (``embed``, ``layers.ln1``, ``layers.attn.wq`` or,
with ``cfg.mla``, ``layers.attn.{wq_a,q_norm,wq_b,wkv_a,kv_norm,wk_b,
wv_b,wo}``, ``layers.mlp.wg`` or ``layers.moe.router``, ``lead_layers.*``,
``ln_f``, ``head``, ``img_proj``), each layer parameter stacked over the
layers as in JAX, so a converted JAX tree loads one to one
(``convert.transformer_params_from_arrays``).  Python loops over the
lead layers and the layers take the place of ``_scan_layers``.

Remat, as in JAX: a training forward under autograd rematerialises each
layer (``set_remat``, on by default; the dry run turns it off for the
FSDP-2D train cells).  JAX's ``REMAT_POLICY`` keeps a layer's input and
its two named outputs, ``attn_out`` and ``mlp_out``; here each layer is
two checkpoint regions, the attention and the FFN, so autograd keeps the
layer's input and the residual sum ``x + attn_out`` (the FFN's input),
one (B, T, D) tensor fewer than JAX's set, and recomputes the rest in
the backward.  The MoE ``aux`` loss leaves the FFN region as an output;
the per-layer bf16 casts happen inside the regions, so none outlives
its layer.

Modes, as in JAX:
  train   -- causal forward, next-token CE loss (``loss_fn``); the MoE
             layers drop tokens past their capacity
  prefill -- causal forward, filling a KV cache when one is given; MoE
             dropless; MLA in its direct form
  decode  -- T new tokens against an existing cache; MoE dropless; MLA
             in its absorbed form

The cache is ``{"layers": {"k", "v": (L, B, S, Hkv, Dh) bf16, "len":
int}}``, or with MLA ``{"layers": {"c_kv": (L, B, S, kv_lora),
"k_rope": (L, B, S, 1, qk_rope) bf16, "len": int}}`` (and ``"lead"``
alike for the dense lead layers of an MoE config): one host length for
all layers, where JAX stacks an int32 ``len`` per layer (see
``layers.attention_block``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.pspec import ParamDef, stack_tree
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import AttnShape, COMPUTE_DTYPE

MODES = ("train", "prefill", "decode")

# JAX's jax.checkpoint_policies.save_only_these_names(...): the values a
# rematerialised layer keeps besides its input (see the module docstring
# for the port's two regions)
REMAT_POLICY = ("attn_out", "mlp_out")

# remat is a memory<->compute trade; under the FSDP-2D train layout the
# per-chip activation footprint is small, so the dry run turns it off there
_USE_REMAT = True


def set_remat(v: bool) -> None:
    """Rematerialise each layer of a training forward (on) or keep every
    activation autograd saves (off)."""
    global _USE_REMAT
    _USE_REMAT = bool(v)


def _attn_shape(cfg: ArchConfig) -> AttnShape:
    return AttnShape(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _layer_defs(cfg: ArchConfig, dense_ffn_width: int | None = None) -> dict:
    d: dict = {"ln1": L.rmsnorm_def(cfg.d_model),
               "ln2": L.rmsnorm_def(cfg.d_model)}
    if cfg.mla is not None:
        d["attn"] = mla_lib.mla_defs(cfg)
    else:
        d["attn"] = L.attention_defs(cfg.d_model, _attn_shape(cfg))
    if dense_ffn_width is not None:
        d["mlp"] = L.mlp_defs(cfg.d_model, dense_ffn_width, cfg.act)
    elif cfg.moe is not None:
        d["moe"] = moe_lib.moe_defs(cfg.d_model, cfg.moe)
    else:
        d["mlp"] = L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act)
    return d


def _n_dense_lead(cfg: ArchConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe else 0


def param_defs(cfg: ArchConfig) -> dict:
    n_lead = _n_dense_lead(cfg)
    defs: dict = {
        "embed": L.embed_defs(cfg.vocab, cfg.d_model),
        "layers": stack_tree(_layer_defs(cfg), cfg.n_layers - n_lead),
        "ln_f": L.rmsnorm_def(cfg.d_model),
    }
    if n_lead:
        defs["lead_layers"] = stack_tree(
            _layer_defs(cfg, dense_ffn_width=cfg.moe.d_ff_dense), n_lead)
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


class _MoE(nn.Module):
    """One stack's ``moe.*`` parameters: the router, the experts and the
    shared experts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in ("router", "wg", "wu", "wd"):
            self.register_parameter(name, nn.Parameter(tree[name]))
        self.shared = (L.ParamGroup(tree["shared"]) if "shared" in tree
                       else None)


class _Layers(nn.Module):
    def __init__(self, tree: dict):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.attn = L.ParamGroup(tree["attn"])
        self.mlp = L.ParamGroup(tree["mlp"]) if "mlp" in tree else None
        self.moe = _MoE(tree["moe"]) if "moe" in tree else None


class Transformer(L.LMModule):
    """The model's parameters and its forward pass.

    Built from a tree of tensors shaped as :func:`param_defs` (the
    tensors become the parameters, not copies).  ``forward(batch, mode,
    cache)`` returns ``(logits (B, T, V) bf16, new_cache, aux)`` like the
    JAX ``forward``; ``aux`` is the MoE layers' summed load-balance loss
    (0 in the dense family).
    """

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, param_defs(cfg), tree)
        self.embed = nn.Parameter(tree["embed"])
        self.layers = _Layers(tree["layers"])
        self.lead_layers = (_Layers(tree["lead_layers"])
                            if "lead_layers" in tree else None)
        self.ln_f = nn.Parameter(tree["ln_f"])
        self.head = nn.Parameter(tree["head"]) if "head" in tree else None
        self.img_proj = (nn.Parameter(tree["img_proj"])
                         if "img_proj" in tree else None)

    def _attn(self, lay: _Layers, i: int, x: torch.Tensor,
              cache: dict | None, *, mode: str,
              prefix_len: int) -> torch.Tensor:
        """Layer ``i``'s attention output (JAX's ``attn_out``)."""
        cfg = self.cfg
        h = L.rmsnorm(lay.ln1[i], x, cfg.norm_eps)
        if cfg.mla is not None:
            # the weights through the kept bf16 copies, the two norm
            # scales in f32
            attn = {n: (p[i] if n.endswith("norm")
                        else self.bf16(lay.attn, n, i))
                    for n, p in lay.attn.named_parameters()}
            a, _ = mla_lib.mla_attention(attn, h, cfg, cache=cache,
                                         absorbed=mode == "decode")
            return a
        attn = {n: self.bf16(lay.attn, n, i)
                for n in ("wq", "wk", "wv", "wo")}
        a, _ = L.attention_block(
            attn, h, shape=_attn_shape(cfg), rope_theta=cfg.rope_theta,
            prefix_len=prefix_len, window=cfg.sliding_window, cache=cache)
        return a

    def _ffn(self, lay: _Layers, i: int, x: torch.Tensor, *, mode: str):
        """Layer ``i``'s FFN output (JAX's ``mlp_out``) and its MoE load-
        balance loss (``None`` in the dense family)."""
        cfg = self.cfg
        h = L.rmsnorm(lay.ln2[i], x, cfg.norm_eps)
        if lay.moe is not None:
            mo = lay.moe
            # the router and the shared experts through the kept bf16
            # copies; the experts in f32, cast per call (no copy kept)
            p = {"router": self.bf16(mo, "router", i),
                 "wg": mo.wg[i], "wu": mo.wu[i], "wd": mo.wd[i]}
            if mo.shared is not None:
                p["shared"] = {n: self.bf16(mo.shared, n, i)
                               for n in ("wg", "wu", "wd")}
            return moe_lib.moe_ffn(p, h, cfg.moe, dropless=mode != "train")
        ffn = {n: self.bf16(lay.mlp, n, i) for n, _ in
               lay.mlp.named_parameters()}
        return L.mlp(ffn, h, cfg.act), None

    def _block(self, lay: _Layers, i: int, x: torch.Tensor,
               cache: dict | None, *, mode: str, prefix_len: int,
               remat: bool = False):
        """Layer ``i`` of the stack ``lay``: attention, then the dense MLP
        or the MoE FFN (dropless unless training); returns ``(x, aux)``.
        With ``remat`` the attention and the FFN are each one checkpoint
        region."""
        attn = functools.partial(self._attn, lay, i, cache=cache, mode=mode,
                                 prefix_len=prefix_len)
        ffn = functools.partial(self._ffn, lay, i, mode=mode)
        if remat:
            attn, ffn = L.remat(attn), L.remat(ffn)
        x = x + attn(x)
        out, aux = ffn(x)
        return x + out, aux

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
        x = L.shard(x, L.BATCH_AXES, None, None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = (mode == "train" and _USE_REMAT
                 and L.records(x, *self.parameters()))
        new_cache = None if cache is None else {}
        stacks = [("layers", self.layers)]
        if self.lead_layers is not None:
            stacks.insert(0, ("lead", self.lead_layers))
        for key, lay in stacks:
            kv = None if cache is None else cache[key]
            for i in range(lay.ln1.shape[0]):
                layer_cache = None if kv is None else {
                    n: (t if n == "len" else t[i]) for n, t in kv.items()}
                x, a = self._block(lay, i, x, layer_cache, mode=mode,
                                   prefix_len=prefix_len, remat=remat)
                if a is not None:
                    aux = aux + a
            if kv is not None:
                # every layer wrote [len, len + T) of its buffers in place
                new_cache[key] = dict(kv, len=kv["len"] + x.shape[1])
        x = L.rmsnorm(self.ln_f, x, cfg.norm_eps)
        if cfg.tie_embeddings:
            lg = L.logits(self.bf16(self, "embed"), x, transpose=True)
        else:
            lg = L.logits(self.bf16(self, "head"), x, transpose=False)
        return lg, new_cache, aux


def forward(cfg: ArchConfig, params: Transformer, batch: dict, *,
            mode: str = "train", cache=None):
    """The JAX signature: ``params`` is the :class:`Transformer` module."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(batch, mode=mode, cache=cache)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> dict:
    """Stacked (L, batch, max_len, Hkv, Dh) bf16 KV buffers, or with MLA
    the stacked latent and rope-key buffers (``mla.init_mla_cache``),
    length 0 (``"lead"`` alike for the dense lead layers).
    ``device=None`` means the card, as at every entry point."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def one(n):
        if cfg.mla is not None:
            c = mla_lib.init_mla_cache(cfg, batch, max_len, device=dev)
            return {k: (t if k == "len" else torch.stack([t] * n))
                    for k, t in c.items()}
        sh = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(sh, dtype=L.COMPUTE_DTYPE, device=dev),
                "v": torch.zeros(sh, dtype=L.COMPUTE_DTYPE, device=dev),
                "len": 0}

    n_lead = _n_dense_lead(cfg)
    out = {"layers": one(cfg.n_layers - n_lead)}
    if n_lead:
        out["lead"] = one(n_lead)
    return out


def loss_fn(cfg: ArchConfig, params: Transformer,
            batch: dict) -> torch.Tensor:
    lg, _, aux = forward(cfg, params, batch, mode="train")
    labels = batch["labels"]
    if cfg.n_image_tokens and "img_embeds" in batch:
        # loss only over text positions
        pad = L.replicated(torch.full(
            (labels.shape[0], cfg.n_image_tokens), -1, dtype=labels.dtype,
            device=labels.device), labels)
        labels = torch.cat([pad, labels], dim=1)
    mask = (labels >= 0).float()
    loss = L.cross_entropy(lg[:, :-1], torch.clamp(labels[:, 1:], min=0),
                           mask[:, 1:])
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss
