"""Shared layer library (port of ``repro.models.layers``): norms, rotary,
grouped-query attention (train / prefill / decode; causal, prefix-LM and
sliding-window masks; the naive and the blockwise form), gated MLPs,
embeddings, logits and the loss.

The JAX dtype steps are kept: products run in bf16 (``COMPUTE_DTYPE``,
each weight cast at its product), attention scores, the softmax, norm
statistics and the loss in f32, parameters stay f32.
:class:`LMModule` holds a model's parameter tree and the bf16 copies its
products read.

``shard`` is JAX's sharding constraint on an activation.  On a plain
tensor it returns the tensor: the models run whole on one card (or on
``meta``), and nothing changes there.  On a DTensor (the dry run's
sharded trace, ``launch.dryrun.trace_sharded``) it redistributes to the
spec filtered to the tensor's mesh, as JAX's ``keep`` filters it;
``set_layout`` switches the axes the batch rides (``BATCH_AXES``) and
drops lone ``"model"`` constraints under FSDP-2D, as in JAX.  Tensors the
models build from host integers (rotary angles, masks, positions) meet
the activations through :func:`replicated`, the counterpart of XLA
treating a constant as replicated.  ``scan_layers`` has no counterpart:
XLA compiles a scan's body once, while eager PyTorch gains nothing from
it, so the models loop over the layers in Python.

Remat is JAX's, through non-reentrant ``torch.utils.checkpoint``
(:func:`remat`): each step of the blockwise attention here, and each
layer of a training forward in the models (``transformer.set_remat``).
A checkpoint runs only where autograd records; serving runs the plain
ops.
"""
from __future__ import annotations

import dataclasses
import math
import sys
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
        self._defs = defs
        self._bf16: dict[tuple[int, str], tuple[int, torch.Tensor]] = {}
        self._embed_dims: dict[tuple[int, str], tuple[int, ...]] | None = None

    def _fsdp_gathered(self, owner: nn.Module, name: str, t: torch.Tensor,
                       index: int | None) -> torch.Tensor:
        """A DTensor copy of ``owner.<name>`` all-gathered on its "embed"
        dims, the dims the rules shard for FSDP: the ZeRO-3 all-gather XLA
        emits for a weight whose contraction dim rides the batch's axes.
        Left to DTensor, a product may instead move the activations onto
        the weight's split and leave a partial sum of the whole output on
        every chip, or split the flat H*k dim of a replicated weight where
        H does not divide the mesh axis and then fail to unflatten it.
        ``t`` as it is otherwise."""
        dt = _dtensor_type()
        if dt is None or not isinstance(t, dt):
            return t
        if self._embed_dims is None:
            logical = {n: d.logical for n, d in tree_items(self._defs)}
            self._embed_dims = {}
            for prefix, m in self.named_modules():
                for n, _ in m.named_parameters(recurse=False):
                    dims = logical[f"{prefix}.{n}" if prefix else n]
                    self._embed_dims[(id(m), n)] = tuple(
                        i for i, a in enumerate(dims) if a == "embed")
        for d in self._embed_dims[(id(owner), name)]:
            t = gathered(t, d - (index is not None))
        return t

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
            return self._fsdp_gathered(owner, name, (
                p if index is None else p[index]).to(COMPUTE_DTYPE), index)
        key = (id(owner), name)
        hit = self._bf16.get(key)
        if (hit is None or hit[0] != p._version
                or hit[1].dtype != COMPUTE_DTYPE):
            hit = (p._version, p.detach().to(COMPUTE_DTYPE))
            self._bf16[key] = hit
        return self._fsdp_gathered(
            owner, name, hit[1] if index is None else hit[1][index], index)


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
# activation layout (the sharded trace)
# ---------------------------------------------------------------------------
# "tp" (heads / mlp constraints on the "model" axis) or "fsdp2d" (no TP:
# "model" is a second data axis, lone "model" constraints drop and the
# batch rides every axis)
_LAYOUT = "tp"
BATCH_AXES = ("pod", "data")  # logical batch -> these mesh axes


def set_layout(mode: str) -> None:
    """The activation layout: ``"tp"`` or ``"fsdp2d"``, as in JAX."""
    global _LAYOUT, BATCH_AXES
    if mode not in ("tp", "fsdp2d"):
        raise ValueError(f"layout {mode!r}; options: 'tp', 'fsdp2d'")
    _LAYOUT = mode
    BATCH_AXES = (("pod", "data", "model") if mode == "fsdp2d"
                  else ("pod", "data"))


def _dtensor_type():
    """The DTensor class once ``torch.distributed.tensor`` is loaded, else
    ``None`` (no DTensor can exist then, and nothing is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """JAX's sharding constraint: ``x`` redistributed to the spec ``axes``
    (one entry a dim, a mesh axis, a tuple of them or ``None``) filtered
    to ``x``'s mesh.  As JAX's ``keep``: an axis the mesh lacks is
    dropped, a dim that does not divide its axes stays unsharded, and a
    lone ``"model"`` drops under ``fsdp2d``.  A plain tensor is returned
    as it is."""
    dt = _dtensor_type()
    if dt is None or not isinstance(x, dt):
        return x
    return _Constraint.apply(x, constraint_placements(x, *axes))


def constraint_placements(x, *axes) -> tuple:
    """The placements :func:`shard` gives the DTensor ``x``: the spec
    ``axes`` filtered to ``x``'s mesh as JAX's ``keep`` filters it."""
    from repro_torch.distributed.pspec import spec_entry
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  unit_dims_whole)

    mesh = x.device_mesh
    if _LAYOUT == "fsdp2d":
        axes = tuple(None if a == "model" else a for a in axes)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def keep(a, dim):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(n for n in a if n in sizes)
            return (kept if kept and dim % math.prod(sizes[n] for n in kept)
                    == 0 else None)
        return a if a in sizes and dim % sizes[a] == 0 else None

    spec = tuple(spec_entry(keep(a, d)) for a, d in zip(axes, x.shape))
    return unit_dims_whole(NamedSharding(mesh, spec).placements(), x.shape)


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is redistributed to ``x``'s own placements
    when ``x`` is a DTensor (XLA gives a cotangent the sharding its
    primal propagated; DTensor's backward may pick a split that a later
    view cannot flatten); a plain tensor as it is."""
    dt = _dtensor_type()
    if dt is None or not isinstance(x, dt):
        return x
    return _Constraint.apply(x, tuple(x.placements))


class _Constraint(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too:
    the transpose of JAX's sharding constraint is the same constraint on
    the cotangent (DTensor's own ``redistribute`` would send the gradient
    back in the input's placements instead)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor built from host integers, replicated on ``like``'s
    mesh when ``like`` is a DTensor (XLA treats such a constant as
    replicated); ``t`` as it is otherwise."""
    dt = _dtensor_type()
    if dt is None or not isinstance(like, dt) or isinstance(t, dt):
        return t
    from torch.distributed.tensor import Replicate
    mesh = like.device_mesh
    return dt.from_local(t, mesh, [Replicate()] * mesh.ndim,
                         run_check=False)


def gathered(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with its ``dim`` whole: a DTensor sharded on ``dim`` is
    all-gathered over those mesh axes; anything else is returned as it
    is."""
    dt = _dtensor_type()
    if dt is None or not isinstance(t, dt):
        return t
    from torch.distributed.tensor import Replicate, Shard
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                       else p for p in t.placements)
    if placements == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, a, b)``.  On DTensors: a product with no
    batch letter (no letter in both operands and the output) as one
    matrix product, each operand's letters grouped output-first, where
    no group's inner letter is split on a mesh axis; any other as a
    broadcast product summed over the contracted letters.
    ``torch.einsum`` instead reshapes both operands into one batched
    product, flattening letter groups that may be split on two mesh axes,
    which DTensor gathers or (in older releases) refuses; the broadcast
    form only permutes, adds unit dims and reduces, and a contracted
    letter split on a mesh axis leaves a partial sum as the product
    would.  Its elements are multiplied and summed in f32, as the
    product accumulates, then cast to ``a``'s dtype: the same numbers
    (``tests/test_torch_collectives.py`` holds the steps to the plain
    ones on a mesh of one rank).  The dry run runs it on ``meta``, where
    the broadcast product allocates nothing."""
    dt = _dtensor_type()
    if dt is None or not isinstance(a, dt):
        return torch.einsum(spec, a, b)
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    con = [c for c in sa if c in sb]
    ao = [c for c in sa if c not in con]
    bo = [c for c in sb if c not in con]
    split = lambda t, s: {s[p.dim] for p in t.placements
                          if getattr(p, "dim", None) is not None}
    inner = (set(ao[1:] + con[1:]) & split(a, sa)
             or set(con[1:] + bo[1:]) & split(b, sb))
    if not set(sa) & set(sb) & set(out) and not inner:
        size = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
        n = lambda cs: math.prod(size[c] for c in cs)
        a2 = a.permute([sa.index(c) for c in ao + con]).reshape(n(ao), n(con))
        b2 = b.permute([sb.index(c) for c in con + bo]).reshape(n(con), n(bo))
        res = (a2 @ b2).view([size[c] for c in ao + bo])
        return res.permute([(ao + bo).index(c) for c in out])
    order = out + "".join(c for c in dict.fromkeys(sa + sb) if c not in out)

    def align(t, s):
        t = t.permute([s.index(c) for c in order if c in s])
        for i, c in enumerate(order):
            if c not in s:
                t = t.unsqueeze(i)
        return t

    prod = _f32_product(align(a, sa), align(b, sb))
    if len(order) == len(out):
        return prod.to(a.dtype)
    return prod.sum(dim=tuple(range(len(out), len(order)))).to(a.dtype)


def _f32_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * y`` with every element in f32 (exact for bf16 operands, as a
    product accumulating in f32 takes them), while DTensor moves the
    operands in their own dtype, as XLA moves a product's bf16 operands:
    ``addcmul`` onto an f32 zero computes in f32 and places ``x`` and
    ``y`` as their product would.  Upcast first, the f32 copies would
    move, twice the bytes."""
    # (1, ..., 1), not (): a 0-dim tensor takes no part in the dtype
    # promotion, and the product would round to bf16
    zero = replicated(torch.zeros((1,) * x.dim(), dtype=torch.float32,
                                  device=x.device), x)
    return torch.addcmul(zero, x, y)


def placed(t: torch.Tensor, placements) -> torch.Tensor:
    """``t`` redistributed to ``placements`` when it is a DTensor placed
    otherwise; ``t`` as it is when it is a plain tensor or ``placements``
    is ``None``."""
    dt = _dtensor_type()
    if (placements is None or dt is None or not isinstance(t, dt)
            or tuple(t.placements) == tuple(placements)):
        return t
    return t.redistribute(t.device_mesh, placements)


def summed(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its pending partial sums reduced: a DTensor with
    ``Partial`` placements is all-reduced over those mesh axes; anything
    else is returned as it is."""
    dt = _dtensor_type()
    if dt is None or not isinstance(t, dt):
        return t
    from torch.distributed.tensor import Partial, Replicate
    placements = tuple(Replicate() if isinstance(p, Partial) else p
                       for p in t.placements)
    if placements == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def per_shard(fn: Callable, inputs, dims, out_dims, n_heads: int, *,
              whole_heads: bool = False):
    """``fn(*inputs)``.  On DTensors it runs shard by shard
    (``local_map``): each chip applies ``fn`` to its own block of batch
    rows and heads, as XLA partitions an op that is independent across
    both (attention, a heads' scan).  Run op by op instead, the reshapes
    and products inside flatten (batch, heads) pairs split on two mesh
    axes, which DTensor gathers whole or (torch 2.11) refuses.

    ``dims[i]`` is ``inputs[i]``'s (batch dim, heads dim), ``None`` where
    it has none; ``out_dims`` is the same for each output (one entry:
    ``fn`` returns a tensor; more: a tuple).  The batch and heads dims of
    ``inputs[0]`` split as JAX's constraint (``BATCH_AXES``, "model")
    splits them; the heads stay whole where ``n_heads`` does not divide
    "model" or ``whole_heads`` holds (a state whose rows flatten (batch,
    heads) splits with the batch only).  Every operand is redistributed
    where it is placed otherwise."""
    dt = _dtensor_type()
    if dt is None or not isinstance(inputs[0], dt):
        return fn(*inputs)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead, (b, h) = inputs[0], dims[0]
    mesh = lead.device_mesh
    spec = [None] * lead.dim()
    spec[b], spec[h] = BATCH_AXES, "model"
    roles = []        # per mesh dim: 0 (the batch), 1 (the heads), None
    for i, p in enumerate(constraint_placements(lead, *spec)):
        heads = (p == Shard(h) and not whole_heads
                 and n_heads % mesh.size(i) == 0)
        roles.append(0 if p == Shard(b) else 1 if heads else None)

    def placements(d):
        return tuple(Replicate() if r is None or d[r] is None
                     else Shard(d[r]) for r in roles)

    ins = tuple(placements(d) for d in dims)
    # local_map reads a tuple as one placement list an output
    outs = tuple(list(placements(d)) for d in out_dims)
    core = local_map(fn, out_placements=outs[0] if len(outs) == 1 else outs,
                     in_placements=ins, device_mesh=mesh)
    return core(*(placed(t, pl) for t, pl in zip(inputs, ins)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    # a DTensor residual with pending partial sums (a product's output
    # over a sharded contraction dim) is reduced in its own dtype, as XLA
    # reduces the product's bf16 output, not in the f32 of the statistics
    xf = summed(x).float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gathered(scale, 0).float()).to(x.dtype)


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
    freq = replicated(theta ** (-torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half), x)
    ang = replicated(positions, x).float()[..., None] * freq  # (B, T, half)
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
    dt = _dtensor_type()
    if dt is not None and isinstance(k, dt):
        return _RepeatHeads.apply(k, groups), _RepeatHeads.apply(v, groups)
    return (torch.repeat_interleave(k, groups, dim=2),
            torch.repeat_interleave(v, groups, dim=2))


class _RepeatHeads(torch.autograd.Function):
    """``repeat_interleave`` over the heads dim of a DTensor.  Its
    gradient sums each group of query heads; where the query heads are
    sharded the groups straddle shards, which DTensor cannot unflatten,
    so the gradient's heads dim is all-gathered first."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return torch.repeat_interleave(t, groups, dim=2)

    @staticmethod
    def backward(ctx, g):
        g = gathered(g, 2)
        B, T, H, D = g.shape
        return g.reshape(B, T, H // ctx.groups, ctx.groups, D).sum(3), None


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
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              prefix_len=prefix_len, window=window, scale=scale)
    dt = _dtensor_type()
    if dt is not None and isinstance(q, dt):
        return _attend_sharded(q, k, v, kw)
    if Tk >= _BLOCKWISE_MIN and Tq > 1:
        return _attend_blockwise(q, k, v, **kw)
    k, v = _kv_heads(k, v, Hq // Hkv)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    mask = _mask(Tq, 0, Tk, device=q.device, causal=causal,
                 q_offset=q_offset, kv_len=kv_len, prefix_len=prefix_len,
                 window=window)
    logits = torch.where(mask[None, None], logits, _MASKED)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _attend_sharded(q, k, v, kw: dict) -> torch.Tensor:
    """:func:`attend` on DTensors: the KV heads repeated and held to
    JAX's constraint (heads on "model"), then the attention run on every
    (batch, heads) block on its own (:func:`per_shard`), q, k and v
    redistributed there where they differ (a cache split on its
    positions).  Before the repeat, k's and v's head_dim is gathered
    whole where a mesh axis splits it (a cache the rules shard on
    "model"), as XLA does: the constraint is then a local slice of a
    replicated dim, where after the repeat it would be an all-to-all of
    the repeated cache."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq > Hkv:
        k, v = gathered(k, 3), gathered(v, 3)
    k, v = _kv_heads(k, v, Hq // Hkv)
    if Hq > Hkv:
        k = shard(k, BATCH_AXES, None, "model", None)
        v = shard(v, BATCH_AXES, None, "model", None)
    return per_shard(lambda q, k, v: attend(q, k, v, **kw), (q, k, v),
                     [(0, 2)] * 3, [(0, 2)], Hq)


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
    q = shard(_heads_proj(xc, p["wq"]), BATCH_AXES, None, "model", None)
    k = shard(_heads_proj(xc, p["wk"]), BATCH_AXES, None, "model", None)
    v = shard(_heads_proj(xc, p["wv"]), BATCH_AXES, None, "model", None)

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
        write_positions(ck, k, cur)
        write_positions(cv, v, cur)
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


def write_positions(buf: torch.Tensor, new: torch.Tensor,
                    cur: int) -> None:
    """``buf[:, cur:cur + T] = new`` in place (``new`` cast to ``buf``'s
    dtype).  A DTensor ``buf`` is written without slicing its positions
    dim, which DTensor would gather whole where the rules split it: every
    shard keeps its positions outside ``[cur, cur + T)`` and takes
    ``new``'s inside, as XLA partitions a dynamic update slice."""
    T = new.shape[1]
    dt = _dtensor_type()
    if dt is None or not isinstance(buf, dt):
        buf[:, cur:cur + T] = new.to(buf.dtype)
        return
    S = buf.shape[1]
    full = new.to(buf.dtype)
    if T > 1 and T < S:     # a prompt: in place at its positions
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        pl = [Replicate() if p == Shard(1) else p for p in full.placements]
        pads = (0, 0) * (new.dim() - 2) + (cur, S - cur - T)
        # padded shard by shard (its positions whole on every chip):
        # DTensor's own pad fails on a split tensor in torch 2.11
        full = local_map(lambda t: F.pad(t, pads), out_placements=pl,
                         in_placements=(pl,),
                         device_mesh=full.device_mesh)(placed(full, pl))
    pos = replicated(torch.arange(S, device=buf.device), buf)
    inside = ((pos >= cur) & (pos < cur + T)).view(
        (1, S) + (1,) * (buf.dim() - 2))
    buf.copy_(torch.where(inside, full, buf))


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
        g = shard(xc @ p["wg"].to(COMPUTE_DTYPE), BATCH_AXES, None, "model")
        u = xc @ p["wu"].to(COMPUTE_DTYPE)
        if act == "relu_sq":
            h = torch.square(torch.relu(g)) * u
        else:
            h = silu(g) * u
    else:
        h = shard(gelu_tanh(xc @ p["wi"].to(COMPUTE_DTYPE)), BATCH_AXES,
                  None, "model")
    out = h @ p["wd"].to(COMPUTE_DTYPE)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits / loss
# ---------------------------------------------------------------------------
def embed_defs(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), ("vocab", "embed"), init="embed")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    dt = _dtensor_type()
    if dt is not None and isinstance(table, dt):
        # DTensor's embedding op, whose backward has a sharding strategy
        # (the backward of an index into a DTensor has none in torch 2.11)
        out = F.embedding(tokens.long(), gathered(table, 1))
    else:
        out = table[tokens.long()]
    return shard(out.to(COMPUTE_DTYPE), BATCH_AXES, None, None)


def logits(table_or_head: torch.Tensor, x: torch.Tensor,
           transpose: bool) -> torch.Tensor:
    """Final projection: ``x @ head`` ((D, V) head) or ``x @ table.T``
    (a tied (V, D) table), in the compute dtype."""
    w = table_or_head.to(COMPUTE_DTYPE)
    return shard(x.to(COMPUTE_DTYPE) @ (w.T if transpose else w),
                 BATCH_AXES, None, "model")


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp(lg, -1)`` of DTensor logits: the max and the sum
    reduced across a split vocab, as XLA partitions it (DTensor's own
    logsumexp gathers the vocab whole), in the plain op's order, and its
    gradient ``g * exp(lg - lse)`` as the plain op's: the same numbers."""

    @staticmethod
    def forward(ctx, lg):
        m = summed(lg.amax(dim=-1, keepdim=True))
        lse = m + torch.log(summed(torch.exp(lg - m).sum(dim=-1,
                                                          keepdim=True)))
        ctx.save_for_backward(lg, lse)
        return lse[..., 0]

    @staticmethod
    def backward(ctx, g):
        lg, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(lg - lse)


def cross_entropy(lg: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL with an f32 logsumexp."""
    lg = lg.float()
    dt = _dtensor_type()
    if dt is not None and isinstance(lg, dt):
        lse = _LogSumExp.apply(lg)
    else:
        lse = torch.logsumexp(lg, dim=-1)
    # on vocab-sharded DTensor logits the gather leaves a masked partial
    # sum, whose mask does not survive the select: reduce it first
    tgt = summed(torch.gather(lg, -1, targets.long()[..., None]))[..., 0]
    nll = lse - tgt
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
