"""Shared layer library (port of ``repro.models.layers``): norms, rotary,
grouped-query attention (train / prefill / decode; causal, prefix-LM and
sliding-window masks; the naive and the blockwise form), gated MLPs,
embeddings, logits and the loss.

The JAX dtype steps are kept: products run in bf16 (``COMPUTE_DTYPE``,
each weight cast at its product), attention scores, the softmax, norm
statistics and the loss in f32, parameters stay f32.
:class:`LMModule` holds a model's parameter tree and the bf16 copies its
products read.

Three JAX functions have no counterpart, each for a reason:

* ``shard`` (a sharding constraint on an activation inside the
  partitioned program) and ``set_layout`` (which rewrites the module
  global ``BATCH_AXES`` the constraints read): the port runs a model whole
  on one card and partitions no program, so there is nothing to
  constrain; the layout the sharding rules need is an argument of
  ``distributed.sharding.batch_spec`` and ``cache_spec`` instead;
* ``scan_layers``: XLA compiles a scan's body once, while eager PyTorch
  gains nothing from it, so the models loop over the layers in Python.

Remat is JAX's, through non-reentrant ``torch.utils.checkpoint``
(:func:`remat`): each step of the blockwise attention here, and each
layer of a training forward in the models (``transformer.set_remat``).
A checkpoint runs only where autograd records; serving runs the plain
ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.pspec import ParamDef, tree_items

COMPUTE_DTYPE = torch.bfloat16
Params = Any    # a nested dict of parameter tensors


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def check_tree(defs, tree) -> None:
    """``tree`` holds exactly the leaves of ``defs``, each of the declared
    shape and dtype; raises ``ValueError`` naming what differs."""
    want = dict(tree_items(defs))
    got = dict(tree_items(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter tree mismatch: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    for name, d in want.items():
        t = got[name]
        if tuple(t.shape) != d.shape or t.dtype != d.dtype:
            raise ValueError(f"{name}: need {d.dtype} {d.shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


class ParamGroup(nn.Module):
    """A flat group of stacked parameters (one subtree of the JAX tree)."""

    def __init__(self, tree: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tree.items():
            self.register_parameter(name, nn.Parameter(t))


class LMModule(nn.Module):
    """Base of the port's LM modules: built from a tree of tensors shaped
    as the model's ``param_defs`` (the tensors become the parameters, not
    copies), with the bf16 copies of the f32 weights its products read."""

    def __init__(self, cfg, defs, tree: dict):
        super().__init__()
        check_tree(defs, tree)
        self.cfg = cfg
        self._bf16: dict[tuple[int, str], tuple[int, torch.Tensor]] = {}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def bf16(self, owner: nn.Module, name: str,
             index: int | None = None) -> torch.Tensor:
        """``owner.<name>`` (its layer ``index`` of a stacked parameter)
        cast to the compute dtype.  Under autograd the cast is made at
        every call (it carries the gradient), of the one layer only: a
        slice of a cast of the whole stack would keep every layer's copy
        alive until the backward.  Otherwise one copy of the whole
        parameter is kept until it changes in place, which gives the same
        numbers as casting at every call."""
        p = getattr(owner, name)
        if torch.is_grad_enabled() and p.requires_grad:
            return (p if index is None else p[index]).to(COMPUTE_DTYPE)
        key = (id(owner), name)
        hit = self._bf16.get(key)
        if (hit is None or hit[0] != p._version
                or hit[1].dtype != COMPUTE_DTYPE):
            hit = (p._version, p.detach().to(COMPUTE_DTYPE))
            self._bf16[key] = hit
        return hit[1] if index is None else hit[1][index]


def records(*tensors: torch.Tensor) -> bool:
    """Autograd records an op on these tensors: grad mode is on and one of
    them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def remat(fn: Callable) -> Callable:
    """``jax.checkpoint(fn)`` with no policy: ``fn`` as one non-reentrant
    checkpoint region, which keeps its arguments and recomputes the rest
    in the backward.  No op of the models draws random numbers, so no RNG
    state is stashed (``preserve_rng_state=False``)."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def groupnorm(x: torch.Tensor, n_groups: int,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim (RWKV6 head-wise ln_x), no affine."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_groups, d // n_groups)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.reshape(*lead, d).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh) with even Dh; positions: (B, T) int.  The angles
    and the rotation in f32 (a bf16 ``x`` times the f32 cos promotes, as
    in JAX), cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq               # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
# The blockwise online-softmax form streams KV in blocks of _KV_BLOCK
# with a running (max, denom, acc) carry instead of holding the (B, H,
# Tq, Tk) f32 probabilities.  As in JAX it takes over whenever
# Tk >= _BLOCKWISE_MIN and Tq > 1: a cached call attends over the whole
# cache, so at max_len = 2048 every prefill takes it.
_BLOCKWISE_MIN = 2048
_KV_BLOCK = 512
# sliding-window decode reads only the last `window` cache positions
_WINDOW_SLICE = True

# the masked-out score: JAX's fill, not -inf, so a row with no visible
# key softmaxes to uniform weights instead of NaN
_MASKED = -1e30


def set_blockwise_min(n: int) -> None:
    """Test/benchmark hook: threshold for the blockwise attention path."""
    global _BLOCKWISE_MIN
    _BLOCKWISE_MIN = n


def set_window_slice(v: bool) -> None:
    """Slice sliding-window decode to the last ``window`` positions (on,
    as in JAX) or mask the whole cache (off)."""
    global _WINDOW_SLICE
    _WINDOW_SLICE = bool(v)


@dataclasses.dataclass(frozen=True)
class AttnShape:
    n_heads: int
    n_kv: int
    d_head: int


def attention_defs(d_model: int, a: AttnShape) -> dict:
    return {
        "wq": ParamDef((d_model, a.n_heads, a.d_head),
                       ("embed", "heads", "head_dim")),
        "wk": ParamDef((d_model, a.n_kv, a.d_head),
                       ("embed", "kv", "head_dim")),
        "wv": ParamDef((d_model, a.n_kv, a.d_head),
                       ("embed", "kv", "head_dim")),
        "wo": ParamDef((a.n_heads, a.d_head, d_model),
                       ("heads", "head_dim", "embed")),
    }


def _kv_heads(k: torch.Tensor, v: torch.Tensor, groups: int):
    """KV heads broadcast to the query heads.  Parity trap: JAX's
    ``jnp.repeat(k, G, axis=2)`` is ``repeat_interleave`` (query head h
    reads KV head h // G), not ``Tensor.repeat`` (which would give
    h % Hkv)."""
    if groups == 1:
        return k, v
    return (torch.repeat_interleave(k, groups, dim=2),
            torch.repeat_interleave(v, groups, dim=2))


def _mask(Tq: int, k0: int, n: int, *, device, causal, q_offset, kv_len,
          prefix_len, window) -> torch.Tensor:
    """(Tq, n) visibility of key positions ``k0 .. k0+n-1``, JAX's mask
    terms in JAX's order.  Every bound is a host integer, so building it
    never waits on the card."""
    qpos = q_offset + torch.arange(Tq, device=device)[:, None]
    kpos = k0 + torch.arange(n, device=device)[None, :]
    mask = torch.ones((Tq, n), dtype=torch.bool, device=device)
    if causal:
        cm = kpos <= qpos
        if prefix_len != 0:
            cm = cm | (kpos < prefix_len)
        mask = mask & cm
    if window:
        mask = mask & (kpos > qpos - window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    return mask


def attend(
    q: torch.Tensor,               # (B, Tq, Hq, Dh)
    k: torch.Tensor,               # (B, Tk, Hkv, Dh)
    v: torch.Tensor,               # (B, Tk, Hkv, Dv)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_len: int | None = None,     # valid cache length (decode)
    prefix_len: int = 0,           # prefix-LM bidirectional span
    window: int = 0,               # sliding window (0 = full)
    scale: float | None = None,
) -> torch.Tensor:
    """Grouped-query attention with composable masking, f32 softmax.

    Parity traps: the scores are f32 from bf16 inputs (JAX's
    ``preferred_element_type=jnp.float32``), so q and k are upcast before
    the product (``torch.einsum`` on bf16 would round its output to
    bf16); the mask fill is -1e30; the probabilities are cast to
    ``v.dtype`` before the PV product.  No
    ``scaled_dot_product_attention``: it computes neither the -1e30 fill
    nor that cast."""
    B, Tq, Hq, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else Dh ** -0.5
    if Tk >= _BLOCKWISE_MIN and Tq > 1:
        return _attend_blockwise(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            prefix_len=prefix_len, window=window, scale=scale)
    k, v = _kv_heads(k, v, Hq // Hkv)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    mask = _mask(Tq, 0, Tk, device=q.device, causal=causal,
                 q_offset=q_offset, kv_len=kv_len, prefix_len=prefix_len,
                 window=window)
    logits = torch.where(mask[None, None], logits, _MASKED)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _attend_blockwise(q, k, v, *, causal, q_offset, kv_len, prefix_len,
                      window, scale, block=None):
    """Online-softmax attention over KV blocks (the FlashAttention
    schedule in plain PyTorch), every step in f32.  Mathematically
    identical to :func:`attend`'s naive path; the tests hold the two to
    each other and to JAX's.  A Python loop over the blocks stands in for
    JAX's scan; as in JAX each step is rematerialised where autograd
    records, so the backward holds one block's logits at a time."""
    B, Tq, Hq, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    k, v = _kv_heads(k, v, Hq // Hkv)
    blk = min(block or _KV_BLOCK, Tk)
    pad = (-Tk) % blk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float()

    def step(acc, m, denom, ki, vi, k0: int):
        ki, vi = ki.float(), vi.float()
        lg = torch.einsum("bthd,bshd->bhts", qf, ki) * scale
        mask = _mask(Tq, k0, blk, device=q.device, causal=causal,
                     q_offset=q_offset, kv_len=kv_len,
                     prefix_len=prefix_len, window=window)
        mask = mask & (k0 + torch.arange(blk, device=q.device) < Tk)
        lg = torch.where(mask[None, None], lg, _MASKED)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhts,bshd->bhtd", p,
                                                    vi)
        return acc, m_new, denom

    if records(q, k, v):
        step = remat(step)
    acc = torch.zeros((B, Hq, Tq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Hq, Tq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((B, Hq, Tq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk + pad, blk):
        acc, m, denom = step(acc, m, denom, k[:, k0:k0 + blk],
                             v[:, k0:k0 + blk], k0)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.transpose(1, 2).to(v.dtype)


def _heads_proj(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btd,dhk->bthk")`` as one (B*T, D) x (D, H*k) product."""
    B, T, D = xc.shape
    return (xc @ w.to(COMPUTE_DTYPE).reshape(D, -1)).view(
        B, T, w.shape[1], w.shape[2])


def attention_block(
    p: dict,
    x: torch.Tensor,                # (B, T, D)
    *,
    shape: AttnShape,
    rope_theta: float = 10000.0,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    prefix_len: int = 0,
    window: int = 0,
    cache: dict | None = None,      # {"k","v" (B, S, Hkv, Dh), "len": int}
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with optional KV cache (prefill fills, decode
    appends).

    Parity trap, the cache length: JAX keeps a per-layer int32 ``len``
    on the device and writes at it with ``dynamic_update_slice``.  Here
    ``len`` is one host integer, so no layer waits on the card to read
    it.  The cache's ``k`` / ``v`` buffers are written in place at
    ``[len, len + T)`` and the returned cache shares them: the dict
    passed in is consumed by the call that extends it.  A write past the
    end raises (JAX would clamp the start and overwrite earlier
    positions)."""
    B, T, _ = x.shape
    xc = x.to(COMPUTE_DTYPE)
    q = _heads_proj(xc, p["wq"])
    k = _heads_proj(xc, p["wk"])
    v = _heads_proj(xc, p["wv"])

    if cache is None:
        pos = positions if positions is not None else (
            torch.arange(T, device=x.device)[None].expand(B, T))
        if rope_theta:
            q, k = rope(q, pos, rope_theta), rope(k, pos, rope_theta)
        out = attend(q, k, v, causal=causal, prefix_len=prefix_len,
                     window=window)
        new_cache = None
    else:
        cur = int(cache["len"])
        ck, cv = cache["k"], cache["v"]
        S = ck.shape[1]
        if cur + T > S:
            raise ValueError(f"KV cache holds {S} positions; {cur} are "
                             f"filled and {T} more do not fit")
        pos = (cur + torch.arange(T, device=x.device))[None].expand(B, T)
        if rope_theta:
            q, k = rope(q, pos, rope_theta), rope(k, pos, rope_theta)
        ck[:, cur:cur + T] = k.to(ck.dtype)
        cv[:, cur:cur + T] = v.to(cv.dtype)
        if window and _WINDOW_SLICE and S > 2 * window and T <= window:
            # sliding-window decode only ever attends to the last
            # `window` positions: slice them out instead of masking the
            # whole cache
            start = min(max(cur + T - window, 0), S - window)
            out = attend(q, ck[:, start:start + window],
                         cv[:, start:start + window], causal=True,
                         q_offset=cur - start, kv_len=cur + T - start,
                         prefix_len=prefix_len, window=window)
        else:
            out = attend(q, ck, cv, causal=True, q_offset=cur,
                         kv_len=cur + T, prefix_len=prefix_len,
                         window=window)
        new_cache = {"k": ck, "v": cv, "len": cur + T}
    wo = p["wo"].to(COMPUTE_DTYPE)
    # a bf16 cache read against f32 products promotes, as in JAX
    dt = torch.promote_types(out.dtype, wo.dtype)
    out = out.reshape(B, T, -1).to(dt) @ wo.reshape(-1, wo.shape[-1]).to(dt)
    return out.to(x.dtype), new_cache


def init_kv_cache(batch: int, max_len: int, shape: AttnShape,
                  dtype=None, device=None) -> dict:
    """An empty KV cache: ``k``, ``v`` (batch, max_len, Hkv, Dh) in the
    compute dtype and the host length 0."""
    dt = dtype if dtype is not None else COMPUTE_DTYPE
    sh = (batch, max_len, shape.n_kv, shape.d_head)
    return {"k": torch.zeros(sh, dtype=dt, device=device),
            "v": torch.zeros(sh, dtype=dt, device=device),
            "len": 0}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it on the CPU: 1 / (1 + exp(-x)),
    each step rounded to ``x``'s dtype.  Parity trap: ``torch.sigmoid``
    on bf16 rounds once, and differs from JAX's in about a third of the
    bf16 values."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s steps, x * sigmoid(x), each rounded to ``x``'s
    dtype (torch's fused silu rounds once)."""
    return x * sigmoid(x)


def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """The constant ``c`` rounded to ``dtype``, as JAX casts a constant to
    the array's dtype before using it."""
    return float(torch.tensor(c, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation) step by step as
    XLA lowers it on the CPU, each step rounded to ``x``'s dtype and the
    two constants cast to it first:
    x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))).  Parity trap:
    ``F.gelu(approximate="tanh")`` on bf16 rounds once."""
    c = _in_dtype(0.044715, x.dtype)
    s = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    cube = (x * x) * x
    cdf = 0.5 * (1.0 + torch.tanh(s * (x + c * cube)))
    return x * cdf


def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    if act in ("silu", "relu_sq"):   # gated
        return {
            "wg": ParamDef((d_model, d_ff), ("embed", "mlp")),
            "wu": ParamDef((d_model, d_ff), ("embed", "mlp")),
            "wd": ParamDef((d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "wd": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (``silu``, ``relu_sq``) or plain (``gelu``) MLP in bf16."""
    xc = x.to(COMPUTE_DTYPE)
    if "wg" in p:
        g = xc @ p["wg"].to(COMPUTE_DTYPE)
        u = xc @ p["wu"].to(COMPUTE_DTYPE)
        if act == "relu_sq":
            h = torch.square(torch.relu(g)) * u
        else:
            h = silu(g) * u
    else:
        h = gelu_tanh(xc @ p["wi"].to(COMPUTE_DTYPE))
    out = h @ p["wd"].to(COMPUTE_DTYPE)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits / loss
# ---------------------------------------------------------------------------
def embed_defs(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "embed"), init="embed")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()].to(COMPUTE_DTYPE)


def logits(table_or_head: torch.Tensor, x: torch.Tensor,
           transpose: bool) -> torch.Tensor:
    """Final projection: ``x @ head`` ((D, V) head) or ``x @ table.T``
    (a tied (V, D) table), in the compute dtype."""
    w = table_or_head.to(COMPUTE_DTYPE)
    return x.to(COMPUTE_DTYPE) @ (w.T if transpose else w)


def cross_entropy(lg: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL with an f32 logsumexp."""
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
