"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing,
shared experts, capacity-based dispatch.

As in JAX, tokens are grouped one group a sequence; each group routes
its tokens into per-expert buffers of capacity ``C`` by cumsum position
assignment (GShard-style dropping), the expert products run batched over
the expert dim, and the outputs gather back with gate weighting.  At
decode token counts the dropless path dispatches by one-hot einsums over
one global group instead (``_moe_decode_einsum``).  JAX reaches no Pallas
kernel here, and the port runs plain PyTorch products.  The expert
buffers carry JAX's sharding constraints (``layers.shard``, the expert
axis on "model"), which act only in the dry run's sharded trace.

Experts whose count does not divide JAX's 16-way expert axis are padded
(Qwen's 60 -> 64); the pad experts are masked out of routing.

Memory: the expert weights are cast to the compute dtype at each call,
as JAX does, and no bf16 copy of them is kept (``LMModule.bf16`` would
add half their f32 bytes again: 30.3 GB for ``qwen2-moe-a2.7b``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.distributed.pspec import ParamDef
from repro_torch.models import layers as L
from repro_torch.models.layers import COMPUTE_DTYPE

# the dropless path switches to the einsum dispatch at B*T <= this
_DECODE_EINSUM_MAX_TOKENS = 1024
_EINSUM_DECODE = True


def set_einsum_decode(v: bool) -> None:
    """Take the einsum dispatch for dropless calls of few tokens (on, as
    in JAX) or always the scatter path (off)."""
    global _EINSUM_DECODE
    _EINSUM_DECODE = bool(v)


def padded_experts(m: MoECfg, ep: int = 16) -> int:
    e = m.n_experts
    return ((e + ep - 1) // ep) * ep if e % ep else e


def moe_defs(d_model: int, m: MoECfg) -> dict:
    E = padded_experts(m)
    F_ = m.d_ff_expert
    d = {
        "router": ParamDef((d_model, E), ("embed", "expert")),
        "wg": ParamDef((E, d_model, F_), ("expert", "embed", "expert_mlp")),
        "wu": ParamDef((E, d_model, F_), ("expert", "embed", "expert_mlp")),
        "wd": ParamDef((E, F_, d_model), ("expert", "expert_mlp", "embed")),
    }
    if m.n_shared:
        Fs = m.d_ff_shared
        d["shared"] = {
            "wg": ParamDef((d_model, Fs), ("embed", "mlp")),
            "wu": ParamDef((d_model, Fs), ("embed", "mlp")),
            "wd": ParamDef((Fs, d_model), ("mlp", "embed")),
        }
    return d


def _route(xc: torch.Tensor, router: torch.Tensor, m: MoECfg, E: int):
    """Router probabilities (f32, pad experts masked with -1e30 before
    the softmax) and the top-k gates, renormalised, and experts.

    Parity trap, ties: ``jax.lax.top_k`` puts the lower index first among
    equal values (at init, pad experts and underflowed experts tie at
    probability 0); ``torch.topk`` promises no order, so this takes the
    first k of a stable descending sort."""
    logits = (xc @ router.to(COMPUTE_DTYPE)).float()
    if E > m.n_experts:
        pad = L.replicated(torch.arange(E, device=xc.device) >= m.n_experts,
                           logits)
        logits = torch.where(pad, -1e30, logits)
    probs = L.pinned(torch.softmax(logits, dim=-1))
    dt = L._dtensor_type()
    if dt is not None and isinstance(probs, dt):
        # the sort's backward mixes a plain index into DTensors (torch
        # 2.11): the same gates gathered at the sorted experts
        eidx = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True)[1][..., :m.top_k]
        gate = torch.gather(probs, -1, eidx)
    else:
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, eidx = vals[..., :m.top_k], idx[..., :m.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) without its range check: on a real
    device ``F.one_hot`` reads the indices' min and max to the host, one
    device sync a call; the indices here are in range by construction."""
    return (idx[..., None] == L.replicated(
        torch.arange(n, device=idx.device), idx)).long()


def _aux(probs: torch.Tensor, eidx: torch.Tensor, m: MoECfg,
         E: int) -> torch.Tensor:
    """The Switch load-balance loss, E * sum_e f_e * p_e, over all tokens."""
    me = probs.reshape(-1, E).mean(dim=0)
    ce = _one_hot(eidx, E).float().sum(dim=-2).reshape(-1, E).mean(dim=0)
    return (me * ce).sum() * m.n_experts


def _expert(p: dict, name: str) -> torch.Tensor:
    """The experts' ``name`` ((E, D, F) ``wg`` / ``wu``, (E, F, D)
    ``wd``) in the compute dtype.  A DTensor is all-gathered on its
    "embed" dim as the model's other weights are (``LMModule.bf16``;
    the experts are read in f32, not through it)."""
    return L.gathered(p[name].to(COMPUTE_DTYPE), 2 if name == "wd" else 1)


def _shared(p: dict, xc: torch.Tensor) -> torch.Tensor:
    s = p["shared"]
    g = L.silu(xc @ s["wg"].to(COMPUTE_DTYPE))
    return (g * (xc @ s["wu"].to(COMPUTE_DTYPE))) @ s["wd"].to(COMPUTE_DTYPE)


def _positions(oh: torch.Tensor) -> torch.Tensor:
    """Each (token, slot)'s place in its expert's buffer.  Parity trap,
    slot order: an int32 cumsum over (token, slot) pairs in token-major,
    then slot-major order.  ``oh``: (..., N*k, E) int32 one-hot."""
    pos = torch.cumsum(oh, dim=-2, dtype=torch.int32) - 1
    return (pos * oh).sum(-1, dtype=torch.int32)


def _moe_decode_einsum(p: dict, x: torch.Tensor, m: MoECfg, E: int):
    """The decode path: one-hot einsum dispatch over ONE global token
    group, dropless at decode token counts (capacity
    ``min(N, max(int(N k / E * 2.0), 16))``)."""
    B, T, D = x.shape
    N, k = B * T, m.top_k
    xf = x.reshape(N, D).to(COMPUTE_DTYPE)
    probs, gate, eidx = _route(xf, p["router"], m, E)        # (N, k)
    C = min(N, max(int(N * k / m.n_experts * 2.0), 16))
    oh = _one_hot(eidx, E).to(torch.int32)                  # (N, k, E)
    pos = _positions(oh.reshape(N * k, E)).reshape(N, k)
    keep = pos < C
    # dispatch mask (N, k, E, C), combined over k: (N, E, C)
    slot = _one_hot(torch.where(keep, pos, C - 1), C).to(torch.int32)
    disp = oh[..., None] * slot[:, :, None, :]
    disp = disp * keep[:, :, None, None].to(torch.int32)
    # parity trap, dtypes: the gated combine weights are f32 until the
    # combine's product casts them
    gated = (disp * gate[:, :, None, None]).sum(1)           # (N, E, C) f32
    disp_b = disp.sum(1).to(COMPUTE_DTYPE)                   # (N, E, C)
    buf = L.shard(L.einsum("nec,nd->ecd", disp_b, xf), "model", None,
                  None)
    h = L.silu(L.einsum("ecd,edf->ecf", buf, _expert(p, "wg")))
    h = h * L.einsum("ecd,edf->ecf", buf, _expert(p, "wu"))
    h = L.shard(h, "model", None, None)
    out_buf = L.einsum("ecf,efd->ecd", h, _expert(p, "wd"))
    out = L.einsum("nec,ecd->nd", gated.to(COMPUTE_DTYPE), out_buf)
    aux = _aux(probs, eidx, m, E)
    if m.n_shared:
        out = out + _shared(p, xf)
    return out.reshape(B, T, D).to(x.dtype), aux.float()


def moe_ffn(p: dict, x: torch.Tensor, m: MoECfg,
            dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D), aux load-balance loss scalar).

    ``p`` holds one layer's ``router``, ``wg``, ``wu``, ``wd`` and
    ``shared.*``, cast to the compute dtype here.  ``dropless``
    (inference): capacity widened to ``min(T, max(C, 16))``, so no token
    drops at small and decode batch sizes; a dropless call of at most
    ``_DECODE_EINSUM_MAX_TOKENS`` tokens takes the einsum dispatch.
    Parity trap, capacity: ``C = max(int(T k / E * capacity_factor), 1)``
    a sequence here, ``min(N, max(int(N k / E * 2), 16))`` over all N
    tokens on the einsum path; so prompts of 300-1100 tokens take both.
    """
    B, T, D = x.shape
    E = p["router"].shape[1]
    if dropless and _EINSUM_DECODE and B * T <= _DECODE_EINSUM_MAX_TOKENS:
        return _moe_decode_einsum(p, x, m, E)
    k = m.top_k
    C = max(int(T * k / m.n_experts * m.capacity_factor), 1)
    if dropless:
        C = min(T, max(C, 16))
    xc = x.to(COMPUTE_DTYPE)
    probs, gate, eidx = _route(xc, p["router"], m, E)       # (B, T, k)
    aux = _aux(probs, eidx, m, E)

    # capacity assignment, a group a sequence
    oh = _one_hot(eidx, E).to(torch.int32)                  # (B, T, k, E)
    pos = _positions(oh.reshape(B, T * k, E)).reshape(B, T, k)
    keep = pos < C

    # dispatch: scatter tokens into (B, E, C, D) buffers.  Dropped
    # tokens add zeros at slot C - 1, so the accumulating scatter is
    # exact in any order
    pos_c = torch.where(keep, pos, C - 1).long()
    contrib = torch.where(keep[..., None], xc[:, :, None, :].expand(
        B, T, k, D), 0.0).to(COMPUTE_DTYPE)
    dtensor = L._dtensor_type()
    if dtensor is not None and isinstance(x, dtensor):
        # DTensor has no sharding strategy for the indexed scatter and
        # gather (torch 2.11): the same sums as one-hot products over the
        # (expert, slot) pairs
        slots = (_one_hot(eidx, E)[..., :, None]
                 * _one_hot(pos_c, C)[..., None, :]).to(COMPUTE_DTYPE)
        buf = L.einsum("btkec,btkd->becd", slots, contrib)
    else:
        bidx = torch.arange(B, device=x.device)[:, None, None].expand(
            B, T, k)
        buf = torch.zeros((B, E, C, D), dtype=COMPUTE_DTYPE,
                          device=x.device)
        buf.index_put_((bidx, eidx, pos_c), contrib, accumulate=True)
    buf = L.shard(buf, ("pod", "data"), "model", None, None)  # EP boundary

    # expert products, batched over the experts
    h = L.silu(L.einsum("becd,edf->becf", buf, _expert(p, "wg")))
    h = h * L.einsum("becd,edf->becf", buf, _expert(p, "wu"))
    h = L.shard(h, ("pod", "data"), "model", None, None)
    out_buf = L.shard(
        L.einsum("becf,efd->becd", h, _expert(p, "wd")),
        ("pod", "data"), "model", None, None)

    # combine: gather back, gate-weighted sum over k (the gates cast to
    # the compute dtype first, as in JAX)
    if dtensor is not None and isinstance(x, dtensor):
        gathered = L.einsum("btkec,becd->btkd", slots, out_buf)
    else:
        gathered = out_buf[bidx, eidx, pos_c]                # (B, T, k, D)
    gathered = torch.where(keep[..., None], gathered, 0.0).to(COMPUTE_DTYPE)
    out = (gathered * gate[..., None].to(COMPUTE_DTYPE)).sum(dim=2)
    if m.n_shared:
        out = out + _shared(p, xc)
    return out.to(x.dtype), aux.float()
