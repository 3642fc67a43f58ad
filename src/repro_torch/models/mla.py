"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), port of
``repro.models.mla``.

Queries and KV are produced through low-rank latents; only the
``kv_lora``-dim latent and the shared rope key are cached (576 values a
token a layer at DeepSeek-V2's widths, against 2 x 128 x 192 for plain
MHA).

Three execution forms, as in JAX:
  * direct, no cache (train): the latents are up-projected to per-head K
    and V and causal attention runs over the T new tokens;
  * direct, cached (prefill): the same over the whole cache after the
    write at ``[len, len + T)``;
  * absorbed, cached (decode): W_UK is folded into the query and W_UV
    into the output, so attention runs in latent space over the cache.

The JAX dtype steps are kept: products in bf16 (``COMPUTE_DTYPE``), the
two score products upcast to f32 first (JAX's
``preferred_element_type=f32``), the mask filled with -1e30, the
softmax in f32 then cast to the compute dtype.  The attention is MLA's
own: ``layers.attend``'s masks and blockwise path are not MLA's.

The cache is ``{"c_kv": (B, S, kv_lora), "k_rope": (B, S, 1, qk_rope),
"len": int}``, written in place; ``len`` is one host integer (JAX keeps
an int32 on the device), and a write past the end raises where JAX's
``dynamic_update_slice`` clamps.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, MLACfg
from repro_torch.distributed.pspec import ParamDef
from repro_torch.models import layers as L
from repro_torch.models.layers import (
    COMPUTE_DTYPE, rmsnorm, rmsnorm_def, rope,
)

# the masked-out score: JAX's fill, not -inf
_MASKED = -1e30


def mla_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    H, D = cfg.n_heads, cfg.d_model
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": ParamDef((D, m.q_lora_rank), ("embed", "lora")),
        "q_norm": rmsnorm_def(m.q_lora_rank),
        "wq_b": ParamDef((m.q_lora_rank, H, qk),
                         ("lora", "heads", "head_dim")),
        "wkv_a": ParamDef((D, m.kv_lora_rank + m.qk_rope_dim),
                          ("embed", "lora")),
        "kv_norm": rmsnorm_def(m.kv_lora_rank),
        "wk_b": ParamDef((m.kv_lora_rank, H, m.qk_nope_dim),
                         ("lora", "heads", "head_dim")),
        "wv_b": ParamDef((m.kv_lora_rank, H, m.v_head_dim),
                         ("lora", "heads", "head_dim")),
        "wo": ParamDef((H, m.v_head_dim, D), ("heads", "head_dim", "embed")),
    }


def _ein(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` on two operands: a bf16 cache read against f32
    operands promotes, as in JAX; bf16 operands give a bf16 result."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return L.einsum(spec, a.to(dt), b.to(dt))


def _scores(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A score product with JAX's ``preferred_element_type=f32``: both
    operands upcast first, so the sum is not rounded to bf16."""
    return L.einsum(spec, a.float(), b.float())


def _w(p: dict, name: str) -> torch.Tensor:
    return p[name].to(COMPUTE_DTYPE)


def _project_latents(p: dict, x: torch.Tensor, m: MLACfg, cfg: ArchConfig):
    xc = x.to(COMPUTE_DTYPE)
    q_lat = rmsnorm(p["q_norm"], xc @ _w(p, "wq_a"), cfg.norm_eps)
    q = _ein("btl,lhd->bthd", q_lat, _w(p, "wq_b"))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    kv = xc @ _w(p, "wkv_a")
    c_kv = rmsnorm(p["kv_norm"], kv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:][:, :, None, :]   # shared across heads
    return q_nope, q_rope, c_kv, k_rope


def _softmax(lg: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    lg = torch.where(mask[None, None], lg, _MASKED)
    dt = L._dtensor_type()
    if dt is not None and isinstance(lg, dt):
        # over cache positions split on a mesh axis: the max and the sum
        # reduced across it, as XLA partitions a softmax (DTensor's own
        # gathers the positions whole)
        e = torch.exp(lg - L.summed(lg.amax(dim=-1, keepdim=True)))
        return (e / L.summed(e.sum(dim=-1, keepdim=True))).to(COMPUTE_DTYPE)
    return torch.softmax(lg, dim=-1).to(COMPUTE_DTYPE)


def _direct(q_nope, q_rope, k_nope, v, k_rope, scale: float):
    """The direct form's causal attention over the projected heads, on
    DTensors run on every (batch, heads) block on its own
    (``layers.per_shard``; the shared rope key has no heads dim), as
    ``layers.attend`` runs: op by op, DTensor's softmax backward and
    score products would gather or refuse head splits."""
    def core(q_nope, q_rope, k_nope, v, k_rope):
        T = q_nope.shape[1]
        lg = (_scores("bthd,bshd->bhts", q_nope, k_nope)
              + _scores("bthd,bsd->bhts", q_rope, k_rope[:, :, 0])) * scale
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q_nope.device))
        return _ein("bhts,bshd->bthd", _softmax(lg, mask), v)

    return L.per_shard(core, (q_nope, q_rope, k_nope, v, k_rope),
                       [(0, 2)] * 4 + [(0, None)], [(0, 2)],
                       q_nope.shape[2])


def mla_attention(
    p: dict, x: torch.Tensor, cfg: ArchConfig, *,
    cache: dict | None = None,
    absorbed: bool = True,
) -> tuple[torch.Tensor, dict | None]:
    """MLA self-attention on x (B, T, D).  ``cache``: ``{"c_kv" (B, S, R),
    "k_rope" (B, S, 1, dr), "len": int}``, written in place at ``[len,
    len + T)``; the returned cache shares its buffers."""
    m = cfg.mla
    B, T, _ = x.shape
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    q_nope, q_rope, c_kv, k_rope = _project_latents(p, x, m, cfg)

    if cache is None:
        pos = torch.arange(T, device=x.device)[None].expand(B, T)
        q_rope = rope(q_rope, pos, cfg.rope_theta)
        k_rope = rope(k_rope, pos, cfg.rope_theta)
        k_nope = _ein("bsl,lhd->bshd", c_kv, _w(p, "wk_b"))
        v = _ein("bsl,lhd->bshd", c_kv, _w(p, "wv_b"))
        out = _direct(q_nope, q_rope, k_nope, v, k_rope, scale)
        new_cache = None
    else:
        cur = int(cache["len"])
        ckv, ckr = cache["c_kv"], cache["k_rope"]
        S = ckv.shape[1]
        if cur + T > S:
            raise ValueError(f"MLA cache holds {S} positions; {cur} are "
                             f"filled and {T} more do not fit")
        pos = (cur + torch.arange(T, device=x.device))[None].expand(B, T)
        q_rope = rope(q_rope, pos, cfg.rope_theta)
        k_rope = rope(k_rope, pos, cfg.rope_theta)
        L.write_positions(ckv, c_kv, cur)
        L.write_positions(ckr, k_rope, cur)
        rope_lg = _scores("bthd,bsd->bhts", q_rope, ckr[:, :, 0])
        if absorbed:
            # fold W_UK into q: q_lat (B, T, H, R); attention in latent space
            q_lat = _ein("bthd,lhd->bthl", q_nope, _w(p, "wk_b"))
            lg = (_scores("bthl,bsl->bhts", q_lat, ckv) + rope_lg) * scale
        else:
            k_nope = _ein("bsl,lhd->bshd", ckv, _w(p, "wk_b"))
            lg = (_scores("bthd,bshd->bhts", q_nope, k_nope)
                  + rope_lg) * scale
        qpos = cur + torch.arange(T, device=x.device)[:, None]
        kpos = torch.arange(S, device=x.device)[None, :]
        pr = _softmax(lg, L.replicated((kpos <= qpos) & (kpos < cur + T),
                                       lg))
        if absorbed:
            o_lat = _ein("bhts,bsl->bthl", pr, ckv)       # latent output
            out = _ein("bthl,lhd->bthd", o_lat, _w(p, "wv_b"))
        else:
            v = _ein("bsl,lhd->bshd", ckv, _w(p, "wv_b"))
            out = _ein("bhts,bshd->bthd", pr, v)
        new_cache = {"c_kv": ckv, "k_rope": ckr, "len": cur + T}

    out = L.shard(out, L.BATCH_AXES, None, "model", None)
    out = _ein("bthd,hdo->bto", out, _w(p, "wo"))
    return out.to(x.dtype), new_cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype: torch.dtype = COMPUTE_DTYPE,
                   device: "str | torch.device | None" = None) -> dict:
    """An empty MLA cache of ``max_len`` positions.  The dtype default is
    bound at import (bf16), as JAX's is, so a test that sets the
    products to f32 keeps a bf16 cache in both packages."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, 1, m.qk_rope_dim),
                              dtype=dtype, device=device),
        "len": 0,
    }
