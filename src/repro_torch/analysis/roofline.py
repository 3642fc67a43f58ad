"""Roofline terms from the port's own op and collective counts (port of
``repro.analysis.roofline``).

Hardware model: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and
NVLink 4 at 900 GB/s bidirectional, 450 GB/s a direction (``LINK_BW``).

Terms per (arch x shape x mesh):
    compute    = FLOPs / (chips * peak)
    memory     = bytes / (chips * hbm_bw)
    collective = collective bytes per chip / link_bw

The JAX package reads its counts from XLA (``cost_analysis`` of the
partitioned program, collectives parsed from its HLO text).  The port
has no HLO.  It counts its own eager program instead.

:class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op the step
dispatches (forward, autograd's backward and the optimizer) and counts

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
Zamba2 count ``chunk_scan``'s plain form).  The global counts over
``chips`` are an ideal partition: JAX's SPMD counts include replicated
work, the port's do not.

:class:`CollectiveCounter` counts the collective term, the counterpart
of ``parse_collectives``.  The dry run runs the step a second time as a
sharded program (``launch.dryrun.trace_sharded``): every tensor a
DTensor with ``meta`` local shards over a fake process group of the
mesh's size.  DTensor's propagation emits c10d functional collectives
on the local shards, and the counter, entered around the step, sees each
one and maps it to JAX's kinds (``all_reduce`` -> all-reduce,
``all_gather_into_tensor`` -> all-gather, ``reduce_scatter_tensor`` ->
reduce-scatter, ``all_to_all_single`` and DTensor's ``shard_dim_alltoall``
-> all-to-all).  Its bytes are each collective's result shape on one
chip, JAX's accounting.  A collective op it does not know raises.

``LINK_BW`` is one NVLink direction, the rate within a node of 8 cards.
A 256-card mesh spans 32 such nodes, and across nodes a card's network
link is slower, so the term is a lower bound on the collective time, a
model as JAX's one-link ICI term is.

The costs are affine in depth (homogeneous layer stacks), so, as in JAX,
two small depth variants give a line; the port also counts full depth
and checks the line against it.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# --- one NVIDIA H100 SXM, 700 W (data sheet, dense) --------------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, one NVLink 4 direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d functional ops (and DTensor's all-to-all) -> JAX's kind names
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
# ops of those namespaces that move no data
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")

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
class CollectiveStats:
    counts: dict[str, int]
    bytes_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives a sharded step emits, per chip, by JAX's
    kinds (see the module docstring).  DTensor ops pass through untouched
    (``NotImplemented`` lets DTensor run and desugar into collectives on
    the local shards, which then reach this mode)."""

    def __init__(self):
        super().__init__()
        self.counts = {k: 0 for k in COLLECTIVES}
        self.bytes_by_kind = {k: 0 for k in COLLECTIVES}
        self.ops: list[tuple[str, tuple[int, ...], int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        mod = sys.modules.get("torch.distributed.tensor")
        if mod is not None and any(issubclass(t, mod.DTensor)
                                   for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func.overloadpacket.__name__
            if name not in _NOT_COLLECTIVES:
                kind = _COLLECTIVE_KINDS.get(name)
                if kind is None:
                    raise NotImplementedError(
                        f"collective {func} is not counted")
                outs = [t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)]
                nbytes = sum(_nbytes(t) for t in outs)
                self.counts[kind] += 1
                self.bytes_by_kind[kind] += nbytes
                self.ops.append((kind, tuple(outs[0].shape), nbytes))
        return out

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.bytes_by_kind))


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float        # op bytes (unfused bound)
    collective_bytes_per_chip: float | None   # None: not counted
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
        """Collective bytes per chip over one link; ``None`` when the
        sharded trace could not count them."""
        if self.collective_bytes_per_chip is None:
            return None
        return self.collective_bytes_per_chip / LINK_BW

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
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
        t_bound = max(self._terms().values())
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
