"""Mamba2 / SSD blocks (arXiv:2405.21060) and the Zamba2 hybrid
(arXiv:2411.15242), port of ``repro.models.mamba2``: a Mamba2 backbone
with ONE shared transformer block re-invoked every
``cfg.shared_attn_every`` layers.

The SSD recurrence runs through ``kernels.ops.chunk_scan`` in its GLA
form (no bonus), the scalar decay of each head broadcast over its state
channels as in JAX: on the card the hand-written kernel
(``csrc/chunk_scan.cu``), on the CPU its plain chunked version.  The
shared block is the port's ``layers.attention_block`` and ``layers.mlp``
with the config's sliding window.

The parameters are a :class:`Zamba2` module whose names follow the JAX
tree (``embed``, ``mamba_layers.{ln,w_in,conv_w,conv_b,a_log,dt_bias,
d_skip,out_norm,w_out}`` stacked over the layers, ``shared.{ln1,attn.*,
ln2,mlp.*}``, ``ln_f``, ``head``), so a converted JAX tree loads one to
one (``convert.zamba2_params_from_arrays``).  Python loops over the
groups and their layers take the place of the two nested
``scan_layers``; as in JAX, a training forward under autograd
rematerialises each group (its ``shared_attn_every`` Mamba2 layers and
the shared block: one checkpoint region, no policy).  The JAX dtype
steps are kept: activations and products in bf16, the decay, the
recurrence and the skip term in f32.

Decode state: per layer the depthwise-conv tail (B, conv_dim - 1, C)
bf16 and the matrix state (B*H, N, hd) f32 -- O(1) in context; per group
a KV cache of the shared block, ``{"k", "v": (G, B, S, Hkv, Dh) bf16,
"len": int}`` with one host length for all groups (see
``layers.attention_block``), where JAX stacks an int32 ``len`` a group.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.pspec import ParamDef, stack_tree
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnShape, COMPUTE_DTYPE

MODES = ("train", "prefill", "decode")
#: the shared block's KV cache dtype.  JAX's ``init_kv_cache`` binds its
#: default dtype (bf16) at import, so the cache stays bf16 even where a
#: test or check sets the products to f32; the port keeps that
KV_DTYPE = torch.bfloat16


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim     # conv over (x, B, C)
    return d_inner, n_heads, conv_ch


def mamba_defs(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_ch = _dims(cfg)
    in_dim = 2 * d_inner + 2 * s.state_dim + H   # z, x, B, C, dt
    return {
        "ln": L.rmsnorm_def(D),
        "w_in": ParamDef((D, in_dim), ("embed", "mlp")),
        "conv_w": ParamDef((s.conv_dim, conv_ch), ("conv", "mlp"), scale=0.5),
        "conv_b": ParamDef((conv_ch,), ("mlp",), init="zeros"),
        "a_log": ParamDef((H,), ("heads",), init="zeros"),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "d_skip": ParamDef((H,), ("heads",), init="ones"),
        "out_norm": L.rmsnorm_def(d_inner),
        "w_out": ParamDef((d_inner, D), ("mlp", "embed")),
    }


def _attn_shape(cfg: ArchConfig) -> AttnShape:
    return AttnShape(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def shared_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": L.rmsnorm_def(cfg.d_model),
        "attn": L.attention_defs(cfg.d_model, _attn_shape(cfg)),
        "ln2": L.rmsnorm_def(cfg.d_model),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff, cfg.act),
    }


def param_defs(cfg: ArchConfig) -> dict:
    defs: dict[str, Any] = {
        "embed": L.embed_defs(cfg.vocab, cfg.d_model),
        "mamba_layers": stack_tree(mamba_defs(cfg), cfg.n_layers),
        "ln_f": L.rmsnorm_def(cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }
    if cfg.shared_attn_every:
        defs["shared"] = shared_block_defs(cfg)
    return defs


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``.  Parity trap:
    ``F.softplus`` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None):
    """Depthwise causal conv; ``tail``: (B, conv_dim - 1, C) carry or
    None.  Returns ``(silu(conv + b), new_tail)``, the new tail being the
    last conv_dim - 1 inputs (None without a carry).

    Parity trap: the K taps are summed as JAX sums them, Python ``sum``
    from 0 in tap order, every product and partial sum rounded to
    ``xbc``'s dtype (bf16); the tail is carried in that dtype too."""
    K = w.shape[0]
    T = xbc.shape[1]
    pad = torch.zeros_like(xbc[:, :K - 1]) if tail is None else tail.to(
        xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)               # (B, T + K - 1, C)
    out = sum(xp[:, i:i + T] * w[i][None, None] for i in range(K))
    new_tail = xp[:, -(K - 1):] if tail is not None else None
    return L.silu(out + b[None, None]), new_tail


def _ssd(xs, Bs, Cs, dt, a, d_skip, s0, hd: int, chunk: int,
         impl: str | None):
    """The heads' scan of one mixer: xs (B, T, H*hd), Bs and Cs (B, T, N),
    dt and the decay a (B, T, H), the skip d_skip (H,) and the state
    (B*H, N, hd) or None; returns (o (B, T, H*hd) f32, the new state).
    On DTensors it runs shard by shard (``layers.per_shard``), as
    RWKV6's ``_heads_scan`` does and for the same reason."""
    dims = [(0, 2), (0, None), (0, None), (0, 2), (0, 2), (None, 0)]
    if s0 is None:
        return L.per_shard(
            lambda *t: _ssd_local(*t, None, hd, chunk, impl)[0],
            (xs, Bs, Cs, dt, a, d_skip), dims, [(0, 2)], dt.shape[-1]), None
    return L.per_shard(
        lambda *t: _ssd_local(*t, hd, chunk, impl),
        (xs, Bs, Cs, dt, a, d_skip, s0), dims + [(0, None)],
        [(0, 2), (0, None)], dt.shape[-1], whole_heads=True)


def _ssd_local(xs, Bs, Cs, dt, a, d_skip, s0, hd: int, chunk: int,
               impl: str | None):
    """:func:`_ssd` on one chip's tensors."""
    B, T, H = dt.shape
    N = Bs.shape[-1]
    # the chunk-scan form, head-major per sequence (B*H, T, .): v = x
    # dt per head, q = C and k = B shared by every head, the head's
    # decay broadcast over the N state channels; broadcast, then made
    # contiguous (the kernel takes contiguous f32)
    v = (xs.reshape(B, T, H, hd).float() * dt[..., None]).transpose(
        1, 2).reshape(B * H, T, hd)
    q = Cs.float()[:, None].expand(B, H, T, N).reshape(B * H, T, N)
    k = Bs.float()[:, None].expand(B, H, T, N).reshape(B * H, T, N)
    # parity trap, the decay: at init most per-step decays lie below
    # the 0.495 for which the chunked form's +-45 clip is exact, so it
    # departs from the naive recurrence, JAX's chunked form as much
    # as the port's (ROADMAP C); the chunked form is the reference
    decay = a.transpose(1, 2)[..., None].expand(B, H, T, N).reshape(
        B * H, T, N)
    o, s_new = ops.chunk_scan(q, k, v, decay, bonus=None, state=s0,
                              chunk=chunk, impl=impl)
    o = o.reshape(B, H, T, hd).transpose(1, 2)
    # the skip term in f32, after the scan
    o = o + d_skip.float()[None, None, :, None] * xs.reshape(
        B, T, H, hd).float()
    return o.reshape(B, T, H * hd), s_new


class MambaLayers(L.ParamGroup):
    """The stacked ``mamba_layers.*`` parameters and the Mamba2 mixer."""

    def forward(self, model: "Zamba2", i: int, x: torch.Tensor,
                state: dict | None, impl: str | None):
        """Layer ``i``'s mixer with its residual.  state: None or {conv
        (B, K-1, C), S (B*H, N, hd)}; returns ``(x + mixer(x),
        new_state)``."""
        cfg = model.cfg
        s = cfg.ssm
        B, T, _ = x.shape
        d_inner, H, conv_ch = _dims(cfg)
        N, hd = s.state_dim, s.head_dim
        w = lambda name: model.bf16(self, name, i)
        xc = L.rmsnorm(self.ln[i], x, cfg.norm_eps).to(COMPUTE_DTYPE)
        proj = xc @ w("w_in")
        z, xbc, dt = torch.split(proj, [d_inner, conv_ch, H], dim=-1)
        tail = None if state is None else state["conv"]
        xbc, new_tail = _causal_conv(xbc, w("conv_w"), w("conv_b"), tail)
        xs, Bs, Cs = torch.split(xbc, [d_inner, N, N], dim=-1)

        dt = _softplus(dt.float() + self.dt_bias[i].float()[None, None])
        a = torch.exp(-dt * torch.exp(self.a_log[i].float())[None, None])

        s0 = None if state is None else state["S"]
        o, s_new = _ssd(xs, Bs, Cs, dt, a, self.d_skip[i], s0, hd, s.chunk,
                        impl)
        o = o.to(COMPUTE_DTYPE)
        o = L.rmsnorm(self.out_norm[i], o * L.silu(z), cfg.norm_eps)
        out = (o @ w("w_out")).to(x.dtype)
        new_state = None
        if state is not None:
            new_state = {"conv": new_tail.to(state["conv"].dtype),
                         "S": s_new}
        return x + out, new_state


class SharedBlock(nn.Module):
    """The one shared attention block (``shared.*``)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"])
        self.ln2 = nn.Parameter(tree["ln2"])
        self.attn = L.ParamGroup(tree["attn"])
        self.mlp = L.ParamGroup(tree["mlp"])

    def forward(self, model: "Zamba2", x: torch.Tensor, cache: dict | None):
        """The block with its residuals.  The sliding window: a decode
        reads only the last ``window`` cache positions once the cache is
        longer than 2 x window (``layers.attention_block``), so at the
        batcher's 2,048 positions the 4,096 window never bites."""
        cfg = model.cfg
        attn = {n: model.bf16(self.attn, n) for n in ("wq", "wk", "wv",
                                                      "wo")}
        a, new_cache = L.attention_block(
            attn, L.rmsnorm(self.ln1, x, cfg.norm_eps),
            shape=_attn_shape(cfg), rope_theta=cfg.rope_theta,
            window=cfg.sliding_window, cache=cache)
        x = x + a
        ffn = {n: model.bf16(self.mlp, n) for n, _ in
               self.mlp.named_parameters()}
        return x + L.mlp(ffn, L.rmsnorm(self.ln2, x, cfg.norm_eps),
                         cfg.act), new_cache


class Zamba2(L.LMModule):
    """The model's parameters and its forward pass.

    Built from a tree of tensors shaped as :func:`param_defs` (the
    tensors become the parameters, not copies).  ``forward(batch, mode,
    cache, impl)`` returns ``(logits (B, T, V) bf16, new_cache, aux)``
    like the JAX ``forward`` (aux 0); ``impl`` goes to ``ops.chunk_scan``
    (None: the kernel on the card, the plain version on the CPU; "ref":
    the plain version anywhere).
    """

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, param_defs(cfg), tree)
        if cfg.shared_attn_every and cfg.n_layers % cfg.shared_attn_every:
            raise ValueError(f"{cfg.n_layers} layers are no multiple of "
                             f"shared_attn_every={cfg.shared_attn_every}")
        self.embed = nn.Parameter(tree["embed"])
        self.mamba_layers = MambaLayers(tree["mamba_layers"])
        self.shared = (SharedBlock(tree["shared"]) if "shared" in tree
                       else None)
        self.ln_f = nn.Parameter(tree["ln_f"])
        self.head = nn.Parameter(tree["head"])

    def forward(self, batch: dict, *, mode: str = "train",
                cache: dict | None = None, impl: str | None = None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}; options: {MODES}")
        cfg = self.cfg
        x = L.shard(L.embed(self.embed, batch["tokens"]), L.BATCH_AXES, None,
                    None)
        every = cfg.shared_attn_every or cfg.n_layers
        m = None if cache is None else cache["mamba"]
        kv = None if cache is None else cache["attn"]
        new_conv, new_s = [], []

        def group(g, x):
            new_st = []
            for i in range(g * every, (g + 1) * every):
                st = None if m is None else {"conv": m["conv"][i],
                                             "S": m["S"][i]}
                x, st = self.mamba_layers(self, i, x, st, impl)
                new_st.append(st)
            if self.shared is not None:
                # group g's cache is written in place at [len, len + T)
                gc = None if kv is None else {"k": kv["k"][g],
                                              "v": kv["v"][g],
                                              "len": kv["len"]}
                x, _ = self.shared(self, x, gc)
            return x, new_st

        if mode == "train" and L.records(x, *self.parameters()):
            group = L.remat(group)
        for g in range(cfg.n_layers // every):
            x, new_st = group(g, x)
            for st in new_st:
                if st is not None:
                    new_conv.append(st["conv"])
                    new_s.append(st["S"])
        x = L.rmsnorm(self.ln_f, x, cfg.norm_eps)
        lg = L.logits(self.bf16(self, "head"), x, transpose=False)
        new_cache = None
        if cache is not None:
            new_cache = {
                "mamba": {"conv": torch.stack(new_conv),
                          "S": torch.stack(new_s)},
                "attn": None if kv is None else {
                    "k": kv["k"], "v": kv["v"],
                    "len": kv["len"] + x.shape[1]}}
        return lg, new_cache, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def forward(cfg: ArchConfig, params: Zamba2, batch: dict, *,
            mode: str = "train", cache=None, impl: str | None = None):
    """The JAX signature: ``params`` is the :class:`Zamba2` module."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(batch, mode=mode, cache=cache, impl=impl)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: "str | torch.device | None" = None) -> dict:
    """Per layer the conv tail and the SSM state (O(1) in ``max_len``),
    per group of the shared block a KV cache of ``max_len`` positions.
    ``device=None`` means the card, as at every entry point."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    s = cfg.ssm
    _, H, conv_ch = _dims(cfg)
    Ln = cfg.n_layers
    out: dict = {"mamba": {
        "conv": torch.zeros((Ln, batch, s.conv_dim - 1, conv_ch),
                            dtype=COMPUTE_DTYPE, device=dev),
        "S": torch.zeros((Ln, batch * H, s.state_dim, s.head_dim),
                         dtype=torch.float32, device=dev)}}
    if cfg.shared_attn_every:
        sh = (Ln // cfg.shared_attn_every, batch, max_len, cfg.n_kv_heads,
              cfg.head_dim)
        out["attn"] = {"k": torch.zeros(sh, dtype=KV_DTYPE, device=dev),
                       "v": torch.zeros(sh, dtype=KV_DTYPE, device=dev),
                       "len": 0}
    else:
        out["attn"] = None
    return out


def loss_fn(cfg: ArchConfig, params: Zamba2, batch: dict) -> torch.Tensor:
    lg, _, _ = forward(cfg, params, batch, mode="train")
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return L.cross_entropy(lg[:, :-1], torch.clamp(labels[:, 1:], min=0),
                           mask[:, 1:])
