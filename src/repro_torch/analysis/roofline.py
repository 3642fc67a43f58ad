"""Roofline terms from the port's own op counts (port of
``repro.analysis.roofline``).

Hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3.

Terms per (arch x shape x mesh):
    compute = FLOPs / (chips * peak)
    memory  = bytes / (chips * hbm_bw)

The JAX package reads its counts from XLA (``cost_analysis`` of the
partitioned program, collectives parsed from its HLO text).  The port
has neither: it runs no partitioned program, its models run whole on one
card, and it never has HLO.  What it can count exactly is its own eager
program: :class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op
the step dispatches (forward, autograd's backward and the optimizer) and
counts

  * FLOPs with ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions and attention; elementwise ops count none there, where
    XLA counts them too);
  * bytes as each op's tensor inputs (each once) and the outputs that are
    not aliases of an input: the eager program's unfused traffic, the
    counterpart of XLA:CPU's unfused "bytes accessed".  Views move no
    bytes; an in-place op counts what it reads, its write aliasing its
    input;
  * ops, the aten ops dispatched that are not views.

A copy from the host to the step's device (Whisper's position table,
made on the CPU) is a transfer, not device traffic: its bytes go to
``h2d_bytes`` and it counts as no op, so a step run on the CPU, where the
copy is no op at all, counts the same.

Run on the ``meta`` device the step allocates nothing, so a full-width,
full-depth step counts in seconds; the same mode on real tensors gives
the same counts (the tests hold that on reduced configs).  A host read
(``.item()``) fails on ``meta`` and fails the count.  A kernel launched
through ``ctypes`` on the card is invisible to a dispatch mode, so counts
are taken on ``meta`` only, where every op is an aten op (RWKV6 and
Zamba2 count ``chunk_scan``'s plain form).

The global counts over ``chips`` are an ideal partition: JAX's SPMD
counts include replicated work, the port's do not.  No source of
collective bytes exists in the port (``parse_collectives`` and
``_shape_bytes`` read HLO text and are not ported), so the collective
term is ``None`` and the bottleneck is taken over compute and memory;
JAX's HLO counts stay the reference for that term.  The costs are affine
in depth (homogeneous layer stacks), so, as in JAX, two small depth
variants give a line; the port also counts full depth and checks the
line against it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# --- one NVIDIA H100 SXM, 700 W (data sheet, dense) --------------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card

_aten = torch.ops.aten
# ops whose schema declares no alias but which return a view or the input
_NO_BYTES = {_aten._unsafe_view.default}


def _is_view(func) -> bool:
    """Every return aliases an input without a write: a view (``view``,
    ``expand``, ``slice``, ``detach``, ``split``, ...)."""
    if func in _NO_BYTES:
        return True
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and ops of every aten op run under it (see the
    module docstring); the counts add up over the mode's life."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.h2d_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func is _aten._to_copy.default and args[0].device.type == "cpu"
                and out.device.type != "cpu"):
            self.h2d_bytes += _nbytes(out)
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not _is_view(func):
            self.ops += 1
            seen: set[int] = set()
            for t in tree_flatten((args, kwargs))[0]:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += _nbytes(t)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for r, t in zip(func._schema.returns, outs):
                if isinstance(t, torch.Tensor) and r.alias_info is None:
                    self.bytes += _nbytes(t)
        return out

    def as_dict(self) -> dict[str, int]:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "h2d_bytes": self.h2d_bytes}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float        # op bytes (unfused bound)
    collective_bytes_per_chip: float | None
    chips: int
    model_flops: float               # 6*N*D (active N for MoE), global
    hbm_bytes_model: float = 0.0     # fusion-aware analytic estimate

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory_hlo(self) -> float:
        """Upper bound: every op's inputs and outputs count as HBM
        traffic (no fusion).  Named as JAX's record names it."""
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_memory(self) -> float:
        """Fusion-aware analytic HBM traffic (see analytic_hbm_bytes);
        falls back to the op bytes when no model was supplied."""
        b = self.hbm_bytes_model or self.hbm_bytes_per_chip
        return b / HBM_BW

    @property
    def t_collective(self) -> float | None:
        """``None``: the port has no source of collective bytes."""
        return None

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs."""
        counted = self.flops_per_chip * self.chips
        return self.model_flops / counted if counted else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOP throughput fraction at the bound set by the
        dominant term: (model_flops/chips/peak) / max(terms)."""
        t_bound = max(self.t_compute, self.t_memory)
        t_useful = self.model_flops / self.chips / PEAK_FLOPS
        return t_useful / t_bound if t_bound else 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "hbm_bytes_model": self.hbm_bytes_model,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_hlo_s": self.t_memory_hlo,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def affine_extrapolate(v1: float, v2: float, n1: int, n2: int,
                       n_full: int) -> float:
    """cost(n) = a + b*n through (n1, v1), (n2, v2), evaluated at n_full."""
    b = (v2 - v1) / (n2 - n1)
    a = v1 - b * n1
    return a + b * n_full


def analytic_hbm_bytes(cfg, shape, mesh_sizes: dict[str, int],
                       cache_bytes_per_chip: int = 0,
                       resident_param_bytes: int = 0) -> float:
    """JAX's fusion-aware per-chip HBM traffic model (bytes per step),
    term for term.

    Terms (bf16 activations/weights-in-compute, f32 master+optimizer):
      weights: 3 fwd-equivalent passes read the TP shard, + optimizer
               read/write of the fully-sharded f32 state (train only);
      activations: ~3 residual-sized tensors/layer (write fwd, read bwd)
               + one live layer working set;
      attention: flash-style q/k/v/out traffic only, no T^2 term;
      moe: dispatch/combine traffic (~6 residual-sized passes of the
               top-k routed copies);
      logits/loss: one f32 vocab-sharded read+write;
      decode: the whole per-chip cache read once per token (+ params).
    """
    from repro_torch.models import model_zoo
    tp = mesh_sizes.get("model", 1)
    dp = mesh_sizes.get("data", 1) * mesh_sizes.get("pod", 1)
    chips = tp * dp
    P = model_zoo.param_count(cfg)
    B = shape.global_batch
    T = 1 if shape.kind == "decode" else shape.seq_len
    tokens_loc = max(B // dp, 1) * T
    D = cfg.d_model
    L = cfg.n_layers
    act_elem = 2  # bf16

    if shape.kind == "decode":
        w = resident_param_bytes or 2 * P / tp
        cache = cache_bytes_per_chip
        act = 10 * L * tokens_loc * D * act_elem
        return float(w + cache + act)

    train = shape.kind == "train"
    passes = 3 if train else 1              # fwd + bwd + remat-fwd
    w = passes * 2 * (P / tp) * 2
    if train:
        w += 6 * (P / chips) * 4            # adam m/v/p read+write (f32)
    saved = 3 * L * tokens_loc * D * act_elem
    act = (2 if train else 1) * saved
    h_frac = max(cfg.n_heads // tp, 1) / cfg.n_heads
    attn = passes * 4 * L * tokens_loc * cfg.n_heads * cfg.head_dim \
        * h_frac * act_elem
    moe = 0.0
    if cfg.moe is not None:
        moe = passes * 6 * L * tokens_loc * cfg.moe.top_k * D * act_elem / tp
    logits = 2 * tokens_loc * (cfg.vocab / tp) * 4
    return float(w + act + attn + moe + logits)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D forward-only (prefill/decode)."""
    from repro_torch.models import model_zoo
    n = model_zoo.param_count(cfg, active_only=cfg.moe is not None)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family.value == "audio":
            tokens = shape.global_batch * (shape.seq_len // cfg.dec_ratio
                                           + shape.seq_len)  # dec + enc share
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
