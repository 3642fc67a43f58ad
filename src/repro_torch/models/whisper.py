"""Whisper-style encoder-decoder (arXiv:2212.04356), port of
``repro.models.whisper``.

The conv frontend is a stub, as in JAX: the encoder takes precomputed
frame embeddings (B, T_enc, d_model).  Encoder: bidirectional
self-attention with sinusoidal positions.  Decoder: causal
self-attention, then cross-attention to the encoder output, learned
positions, a head tied to the embeddings.  Decode caches both the
self-attention KV and the (fixed) cross-attention KV.

The parameters are a :class:`Whisper` module whose names follow the JAX
tree (``embed``, ``dec_pos``, ``enc_layers.{ln1,attn.*,ln2,mlp.*}`` and
``dec_layers.{ln1,attn.*,ln_x,xattn.*,ln2,mlp.*}`` stacked over the
layers, ``ln_enc``, ``ln_f``), so a converted JAX tree loads one to one
(``convert.whisper_params_from_arrays``).  Python loops over the layers
take the place of ``scan_layers`` and ``lax.map``.  No remat: JAX
checkpoints each encoder layer and, in training, each decoder layer, but
neither launcher trains Whisper (a token batch has no audio frames), so
only the gradient tests reach its backward, at reduced widths.

The cache keeps JAX's layout: ``{"self": {"k", "v": (L, B, S, H, Dh)
bf16, "len": int}, "xkv": (k, v) each (L, B, T_enc, H, Dh), "enc_out":
(B, T_enc, D), "len": int}``, both lengths host integers where JAX keeps
int32s on the device (see ``layers.attention_block``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.pspec import ParamDef, stack_tree
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnShape, COMPUTE_DTYPE

MODES = ("train", "prefill", "decode")
MAX_DEC_POS = 65536   # covers decode_32k; whisper's 448 is a runtime limit
#: the self-attention cache dtype: JAX's ``init_kv_cache`` binds its
#: default (bf16) at import, so it stays bf16 where a test sets the
#: products to f32
KV_DTYPE = torch.bfloat16


def _shape(cfg: ArchConfig) -> AttnShape:
    return AttnShape(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _enc_layer_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.rmsnorm_def(cfg.d_model),
        "attn": L.attention_defs(cfg.d_model, _shape(cfg)),
        "ln2": L.rmsnorm_def(cfg.d_model),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def _dec_layer_defs(cfg: ArchConfig) -> dict:
    d = _enc_layer_defs(cfg)
    d["ln_x"] = L.rmsnorm_def(cfg.d_model)
    d["xattn"] = L.attention_defs(cfg.d_model, _shape(cfg))
    return d


def param_defs(cfg: ArchConfig) -> dict:
    return {
        "embed": L.embed_defs(cfg.vocab, cfg.d_model),
        "dec_pos": ParamDef((MAX_DEC_POS, cfg.d_model), (None, "embed"),
                            init="embed"),
        "enc_layers": stack_tree(_enc_layer_defs(cfg), cfg.enc_layers),
        "dec_layers": stack_tree(_dec_layer_defs(cfg), cfg.n_layers),
        "ln_enc": L.rmsnorm_def(cfg.d_model),
        "ln_f": L.rmsnorm_def(cfg.d_model),
    }


def _sinusoid(T: int, d: int) -> torch.Tensor:
    """The encoder's (T, d) f32 position table on the CPU, JAX's steps:
    angles pos / 10000^(i / (d/2)), then [sin | cos].

    Parity trap: XLA's f32 ``pow`` is the f64 power rounded to f32 here,
    and torch's f32 ``pow`` differs from it in a few ulps (4 of the 512
    frequencies at d = 1024), which moves whole columns of angles up to
    1,500 rad; so the power runs in f64 and is rounded once.  The sines
    and cosines then differ from XLA's in the last f32 bits but not once
    the table is cast to bf16 (``tests/test_torch_whisper.py``).  Made on
    the CPU, so the card reads the same table."""
    pos = torch.arange(T, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
    freq = (10000.0 ** (dim / (d // 2)).double()).float()
    ang = pos / freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _Layers(nn.Module):
    """One stack (``enc_layers`` or ``dec_layers``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in ("ln1", "ln2", "ln_x"):
            if name in tree:
                self.register_parameter(name, nn.Parameter(tree[name]))
        for name in ("attn", "mlp", "xattn"):
            if name in tree:
                setattr(self, name, L.ParamGroup(tree[name]))


class Whisper(L.LMModule):
    """The model's parameters and its forward pass.

    Built from a tree of tensors shaped as :func:`param_defs` (the
    tensors become the parameters, not copies).  ``forward(batch, mode,
    cache)`` returns ``(logits (B, T, V) bf16, new_cache, aux)`` like the
    JAX ``forward`` (aux 0).
    """

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, param_defs(cfg), tree)
        self.embed = nn.Parameter(tree["embed"])
        self.dec_pos = nn.Parameter(tree["dec_pos"])
        self.enc_layers = _Layers(tree["enc_layers"])
        self.dec_layers = _Layers(tree["dec_layers"])
        self.ln_enc = nn.Parameter(tree["ln_enc"])
        self.ln_f = nn.Parameter(tree["ln_f"])

    def _group(self, owner: nn.Module, i: int) -> dict:
        """Layer ``i``'s weights of a group, through the kept bf16 copies."""
        return {n: self.bf16(owner, n, i) for n, _ in owner.named_parameters()}

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, d_model) stub embeddings -> encoder output
        (B, T_enc, d_model) in the compute dtype."""
        cfg = self.cfg
        table = _sinusoid(frames.shape[1], cfg.d_model).to(COMPUTE_DTYPE)
        x = frames.to(COMPUTE_DTYPE) + L.replicated(
            table.to(frames.device), frames)[None]
        x = L.shard(x, L.BATCH_AXES, None, None)
        lay = self.enc_layers
        for i in range(cfg.enc_layers):
            h = L.rmsnorm(lay.ln1[i], x, cfg.norm_eps)
            a, _ = L.attention_block(self._group(lay.attn, i), h,
                                     shape=_shape(cfg), rope_theta=0.0,
                                     causal=False)
            x = x + a
            h = L.rmsnorm(lay.ln2[i], x, cfg.norm_eps)
            x = x + L.mlp(self._group(lay.mlp, i), h, cfg.act)
        return L.rmsnorm(self.ln_enc, x, cfg.norm_eps)

    def xattn_kv(self, i: int, enc_out: torch.Tensor):
        """Decoder layer ``i``'s cross-attention K and V (B, T_enc, H, Dh)
        from the encoder output (JAX's ``_xattn_kv``)."""
        p = self.dec_layers.xattn
        return (L._heads_proj(enc_out, self.bf16(p, "wk", i)),
                L._heads_proj(enc_out, self.bf16(p, "wv", i)))

    def _dec_block(self, i: int, x: torch.Tensor, enc_out, cache, xkv):
        cfg = self.cfg
        lay = self.dec_layers
        h = L.rmsnorm(lay.ln1[i], x, cfg.norm_eps)
        a, new_cache = L.attention_block(self._group(lay.attn, i), h,
                                         shape=_shape(cfg), rope_theta=0.0,
                                         cache=cache)
        x = x + a
        # cross attention (the K/V precomputed at prefill when cached)
        h = L.rmsnorm(lay.ln_x[i], x, cfg.norm_eps)
        q = L._heads_proj(h.to(COMPUTE_DTYPE), self.bf16(lay.xattn, "wq", i))
        k, v = self.xattn_kv(i, enc_out) if xkv is None else xkv
        a = L.attend(q, k, v, causal=False)
        wo = self.bf16(lay.xattn, "wo", i)
        B, T = a.shape[:2]
        dt = torch.promote_types(a.dtype, wo.dtype)
        a = a.reshape(B, T, -1).to(dt) @ wo.reshape(-1, wo.shape[-1]).to(dt)
        x = x + a.to(x.dtype)
        h = L.rmsnorm(lay.ln2[i], x, cfg.norm_eps)
        return x + L.mlp(self._group(lay.mlp, i), h, cfg.act), new_cache

    def forward(self, batch: dict, *, mode: str = "train",
                cache: dict | None = None):
        """batch: ``frames`` (B, T_enc, D) [train, and prefill], ``tokens``
        (B, T_dec).  Without ``frames`` the encoder output and the
        cross-attention K/V come from ``cache``."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}; options: {MODES}")
        cfg = self.cfg
        tokens = batch["tokens"]
        T = tokens.shape[1]
        xkv = None if cache is None else cache["xkv"]
        if "frames" in batch:
            # train/prefill: run the encoder; at prefill also precompute
            # every layer's cross-attention K/V for the cache
            enc_out = self.encode(batch["frames"])
            if cache is not None:
                kv = [self.xattn_kv(i, enc_out) for i in range(cfg.n_layers)]
                xkv = (torch.stack([k for k, _ in kv]),
                       torch.stack([v for _, v in kv]))
        else:
            enc_out = cache["enc_out"]
        offset = 0 if cache is None else int(cache["len"])
        pos_emb = self.dec_pos[offset:offset + T]
        x = L.embed(self.embed, tokens) + pos_emb[None].to(COMPUTE_DTYPE)
        x = L.shard(x, L.BATCH_AXES, None, None)
        sc = None if cache is None else cache["self"]
        for i in range(cfg.n_layers):
            layer_cache = None if sc is None else {
                "k": sc["k"][i], "v": sc["v"][i], "len": sc["len"]}
            x, _ = self._dec_block(i, x, enc_out, layer_cache,
                                   None if xkv is None else (xkv[0][i],
                                                             xkv[1][i]))
        x = L.rmsnorm(self.ln_f, x, cfg.norm_eps)
        lg = L.logits(self.bf16(self, "embed"), x, transpose=True)  # tied
        new_cache = None
        if cache is not None:
            # every layer wrote [len, len + T) of its self-attention
            # buffers in place
            new_cache = {"self": dict(sc, len=sc["len"] + T), "xkv": xkv,
                         "enc_out": enc_out, "len": offset + T}
        return lg, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def encode(cfg: ArchConfig, params: Whisper,
           frames: torch.Tensor) -> torch.Tensor:
    """The JAX signature: ``params`` is the :class:`Whisper` module."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params.encode(frames)


def forward(cfg: ArchConfig, params: Whisper, batch: dict, *,
            mode: str = "train", cache=None):
    """The JAX signature: ``params`` is the :class:`Whisper` module."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(batch, mode=mode, cache=cache)


def _self_cache(cfg: ArchConfig, batch: int, max_len: int,
                dev: torch.device) -> dict:
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(sh, dtype=KV_DTYPE, device=dev),
            "v": torch.zeros(sh, dtype=KV_DTYPE, device=dev), "len": 0}


@torch.no_grad()
def make_cache(cfg: ArchConfig, params: Whisper, frames: torch.Tensor,
               max_len: int) -> dict:
    """The decode cache: the encoder output and every layer's cross K/V
    from ``frames``, an empty self-attention cache of ``max_len``."""
    enc_out = encode(cfg, params, frames)
    kv = [params.xattn_kv(i, enc_out) for i in range(cfg.n_layers)]
    return {"self": _self_cache(cfg, frames.shape[0], max_len,
                                frames.device),
            "xkv": (torch.stack([k for k, _ in kv]),
                    torch.stack([v for _, v in kv])),
            "enc_out": enc_out, "len": 0}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> dict:
    """A zero cache of JAX's shapes: the encoder output and the cross K/V
    sized for ``max(max_len // dec_ratio, 1)`` frames (a prefill with
    ``frames`` replaces both).  ``device=None`` means the card, as at
    every entry point."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    t_enc = max(max_len // cfg.dec_ratio, 1)
    sh = (cfg.n_layers, batch, t_enc, cfg.n_kv_heads, cfg.head_dim)
    return {"self": _self_cache(cfg, batch, max_len, dev),
            "xkv": (torch.zeros(sh, dtype=COMPUTE_DTYPE, device=dev),
                    torch.zeros(sh, dtype=COMPUTE_DTYPE, device=dev)),
            "enc_out": torch.zeros((batch, t_enc, cfg.d_model),
                                   dtype=COMPUTE_DTYPE, device=dev),
            "len": 0}


def loss_fn(cfg: ArchConfig, params: Whisper, batch: dict) -> torch.Tensor:
    lg, _, _ = forward(cfg, params, batch, mode="train")
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return L.cross_entropy(lg[:, :-1], torch.clamp(labels[:, 1:], min=0),
                           mask[:, 1:])
