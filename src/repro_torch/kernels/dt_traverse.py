"""CUDA kernel B: partitioned-subtree range-mark matching.

Replaces the Pallas TPU kernel ``dt_traverse_pallas``
(``src/repro/kernels/dt_traverse.py``).  The kernel source is
``src/repro_torch/csrc/dt_traverse.cu``, one kernel with two entry
points, each with its plain version, which it must equal bit for bit:

- the per-flow form, :func:`dt_traverse_flows_kernel` (plain version
  :func:`dt_traverse_flows_ref`): registers ``(B, k)`` and one SID a flow,
  ``-1`` reading row ``S - 1`` as a negative index does;
- the block form, :func:`dt_traverse_kernel` (plain version
  :func:`dt_traverse_blocks_ref`): the Pallas kernel's signature, one SID
  a block of ``block_b`` flows.

What bounds it on the H100: device memory -- per flow it reads k f32
registers and a SID and writes one int32 action (~25 MB at 2^20 flows and
k = 4, 7.5 us at 3.35 TB/s), and the compares are far below the ALU
rate.  No SID dispatch: each flow reads its own SID and matches against
its own subtree.  Where the tables are small (L <= 32 and the staged form
within 48 KB, as the engine's are) each CTA stages them once in the form
the match wants, a mask of leaves for every (subtree, slot, mark), so a
flow's first hit is one AND of k masks and a find-first-set
(:func:`kernel_path` ``"staged"``); deeper tables are read in place
through the cache, a flow's leaves scanned by one thread or, from
``engine_hop.WARP_MATCH_MIN_LEAVES`` leaves, one warp (``"serial"``,
``"warp"``).  Nothing limits S, T or L; k may be at most :data:`K_MAX`
(the cached path's marks), and the wrappers raise above it.

The ``*_kernel`` functions only launch: they take CUDA tensors and raise
on anything else.  :func:`dt_traverse_blocks` routes the block form by
device; ``dispatch.dispatch_dt_traverse`` launches the per-flow form.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import dt_traverse_ref

BLOCK_B = 128

#: the most slots a launch takes: one flow's k marks fill a CTA's 48 KB
K_MAX = 12288

#: the staged path's limits: a leaf mask is one 32-bit word, and the
#: staged tables stay within the 48 KB a CTA takes without opting in
STAGED_MAX_LEAVES = 32
STAGED_MAX_BYTES = 48 * 1024

#: kernel launches since the last reset, either form (``chip_smoke.py``
#: zeroes it before driving the main path)
launches = 0

_SOURCE = "dt_traverse.cu"


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.dt_traverse_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.dt_traverse_launch.argtypes = [p, p, i, ctypes.c_longlong,
                                           p, p, p, p, p, i, i, i, i, i,
                                           i, p, p]
        lib.dt_traverse_launch.restype = ctypes.c_int
        lib.dt_traverse_error_string.argtypes = [ctypes.c_int]
        lib.dt_traverse_error_string.restype = ctypes.c_char_p
    return lib


def staged_bytes(S: int, k: int, T: int, L: int) -> int:
    """Shared memory of the staged path (``csrc/dt_traverse.cu``
    ``staged_words``): thresholds and leaf masks at odd row strides, the
    valid masks, the actions and one flag, 4 bytes each."""
    return 4 * (S * k * (T | 1) + S * k * ((T + 1) | 1) + S + S * L + 1)


def kernel_path(S: int, k: int, T: int, L: int) -> str:
    """The path kernel B takes on tables of this shape: ``"staged"``,
    ``"warp"`` (cached, a warp a flow's leaves) or ``"serial"`` (cached,
    one thread)."""
    if L <= STAGED_MAX_LEAVES and staged_bytes(S, k, T, L) \
            <= STAGED_MAX_BYTES:
        return "staged"
    from repro_torch.kernels.engine_hop import WARP_MATCH_MIN_LEAVES
    return "warp" if L >= WARP_MATCH_MIN_LEAVES else "serial"


_PATH_CODES = {"serial": 0, "warp": 1, "staged": 2}


def dt_traverse_flows_ref(
    regs: torch.Tensor,        # (B, k) f32 feature registers
    sid: torch.Tensor,         # (B,) int SID of each flow (-1: row S - 1)
    thresholds: torch.Tensor,  # (S, k, T) f32 (+inf padded)
    leaf_lo: torch.Tensor,     # (S, L, k) int32
    leaf_hi: torch.Tensor,     # (S, L, k) int32
    leaf_action: torch.Tensor, # (S, L) int32
    leaf_valid: torch.Tensor,  # (S, L) int32 (0/1)
) -> torch.Tensor:
    """Plain version of kernel B's per-flow form: each row's own subtree
    gathered densely, then ``dt_traverse_ref`` -> action (B,) int32."""
    s = sid.to(torch.int64)
    return dt_traverse_ref(regs, thresholds[s], leaf_lo[s], leaf_hi[s],
                           leaf_action[s], leaf_valid[s] > 0)


def dt_traverse_blocks_ref(
    block_sid: torch.Tensor,   # (nb,) int32 SID of each flow block
    regs: torch.Tensor,        # (nb*block_b, k) f32, grouped by SID
    thresholds: torch.Tensor,  # (S, k, T) f32 (+inf padded)
    leaf_lo: torch.Tensor,     # (S, L, k) int32
    leaf_hi: torch.Tensor,     # (S, L, k) int32
    leaf_action: torch.Tensor, # (S, L) int32
    leaf_valid: torch.Tensor,  # (S, L) int32 (0/1)
    *,
    block_b: int,
) -> torch.Tensor:
    """Plain version of kernel B's block form: action (nb*block_b,)
    int32."""
    sid = block_sid.to(torch.int64).repeat_interleave(block_b)
    return dt_traverse_flows_ref(regs, sid, thresholds, leaf_lo, leaf_hi,
                                 leaf_action, leaf_valid)


def _launch(sid, regs, tables, block_b: int, name: str) -> torch.Tensor:
    """Validate one launch and run it on the current stream; ``block_b``
    0 is the per-flow form."""
    global launches
    dev = regs.device
    if dev.type != "cuda":
        plain = ("dt_traverse_blocks_ref" if block_b
                 else "dt_traverse_flows_ref")
        raise ValueError(f"{name} needs CUDA tensors, got {dev}; its plain "
                         f"version for CPU tensors is {plain}")
    thresholds, leaf_lo, leaf_hi, leaf_action, leaf_valid = tables
    S, k, T = thresholds.shape
    L = leaf_lo.shape[1]
    if not 0 < k <= K_MAX:
        raise ValueError(f"{name}: k must be in 1..{K_MAX}, got {k}")
    B = sid.shape[0] * max(block_b, 1)
    expect = (
        ("sid", sid, torch.int32, (sid.shape[0],)),
        ("regs", regs, torch.float32, (B, k)),
        ("thresholds", thresholds, torch.float32, (S, k, T)),
        ("leaf_lo", leaf_lo, torch.int32, (S, L, k)),
        ("leaf_hi", leaf_hi, torch.int32, (S, L, k)),
        ("leaf_action", leaf_action, torch.int32, (S, L)),
        ("leaf_valid", leaf_valid, torch.int32, (S, L)),
    )
    for arg, x, dt, shape in expect:
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: {arg} needs a contiguous {dt} {shape} tensor on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    if S == 0:
        raise ValueError(f"{name}: the tables hold no subtree")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = lib.dt_traverse_launch(
        regs.data_ptr(), sid.data_ptr(), block_b, B,
        *(t.data_ptr() for t in tables), S, k, T, L,
        _PATH_CODES[kernel_path(S, k, T, L)], sms, out.data_ptr(), stream)
    if err != 0:
        msg = lib.dt_traverse_error_string(err).decode()
        raise RuntimeError(f"dt_traverse kernel launch failed: {msg}")
    launches += 1
    return out


def dt_traverse_flows_kernel(
    regs: torch.Tensor,
    sid: torch.Tensor,
    thresholds: torch.Tensor,
    leaf_lo: torch.Tensor,
    leaf_hi: torch.Tensor,
    leaf_action: torch.Tensor,
    leaf_valid: torch.Tensor,
) -> torch.Tensor:
    """Launch kernel B's per-flow form on the current stream (arguments
    as :func:`dt_traverse_flows_ref`, ``sid`` int32); returns action
    (B,) int32."""
    return _launch(sid, regs, (thresholds, leaf_lo, leaf_hi, leaf_action,
                               leaf_valid), 0, "dt_traverse_flows_kernel")


def dt_traverse_kernel(
    block_sid: torch.Tensor,
    regs: torch.Tensor,
    thresholds: torch.Tensor,
    leaf_lo: torch.Tensor,
    leaf_hi: torch.Tensor,
    leaf_action: torch.Tensor,
    leaf_valid: torch.Tensor,
    *,
    block_b: int,
) -> torch.Tensor:
    """Launch kernel B's block form on the current stream (arguments as
    :func:`dt_traverse_blocks_ref`); returns action (nb*block_b,)
    int32."""
    if not 0 < block_b <= 1024:
        raise ValueError(f"block_b must be in 1..1024, got {block_b}")
    return _launch(block_sid, regs, (thresholds, leaf_lo, leaf_hi,
                                     leaf_action, leaf_valid), block_b,
                   "dt_traverse_kernel")


def dt_traverse_blocks(block_sid, regs, thresholds, leaf_lo, leaf_hi,
                       leaf_action, leaf_valid, *, block_b: int
                       ) -> torch.Tensor:
    """Block-level range match: kernel B for CUDA tensors, the plain
    version for CPU tensors."""
    fn = dt_traverse_kernel if regs.device.type == "cuda" \
        else dt_traverse_blocks_ref
    return fn(block_sid, regs, thresholds, leaf_lo, leaf_hi, leaf_action,
              leaf_valid, block_b=block_b)
