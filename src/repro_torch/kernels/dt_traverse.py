"""CUDA kernel B: partitioned-subtree range-mark matching.

Replaces the Pallas TPU kernel ``dt_traverse_pallas``
(``src/repro/kernels/dt_traverse.py``).  The kernel source is
``src/repro_torch/csrc/dt_traverse.cu``; its plain version is
:func:`dt_traverse_blocks_ref`, which it must equal exactly.

What bounds it on the H100: device memory, barely -- per flow it reads
k f32 registers and writes one int32 action (~21 MB at 2^20 flows and
k = 4, a few microseconds at 3.35 TB/s), and the compares are far below
the ALU rate.  Flows arrive grouped into SID-homogeneous blocks of
``block_b`` rows (``kernels.dispatch``); one thread block serves one
flow block, reads its SID itself, stages that subtree's thresholds and
leaf tables in dynamic shared memory (sized from k, T, L and allowed
above 48 KB; tables too large for a block make the launch fail, which
raises), and each thread matches one flow against them.

:func:`dt_traverse_kernel` only launches: it takes CUDA tensors and
raises on anything else.  :func:`dt_traverse_blocks` routes by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import dt_traverse_ref

BLOCK_B = 128

#: kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the main path)
launches = 0

_SOURCE = "dt_traverse.cu"


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.dt_traverse_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.dt_traverse_launch.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, p]
        lib.dt_traverse_launch.restype = ctypes.c_int
        lib.dt_traverse_error_string.argtypes = [ctypes.c_int]
        lib.dt_traverse_error_string.restype = ctypes.c_char_p
    return lib


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
    """Plain version of kernel B: action (nb*block_b,) int32."""
    sid = block_sid.to(torch.int64).repeat_interleave(block_b)
    return dt_traverse_ref(regs, thresholds[sid], leaf_lo[sid], leaf_hi[sid],
                           leaf_action[sid], leaf_valid[sid] > 0)


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
    """Launch kernel B on the current stream (arguments as
    :func:`dt_traverse_blocks_ref`); returns action (nb*block_b,) int32."""
    global launches
    dev = regs.device
    if dev.type != "cuda":
        raise ValueError(f"dt_traverse_kernel needs CUDA tensors, got {dev}; "
                         "use dt_traverse_blocks to route CPU tensors to "
                         "the plain version")
    if not 0 < block_b <= 1024:
        raise ValueError(f"block_b must be in 1..1024, got {block_b}")
    nb = block_sid.shape[0]
    S, k, T = thresholds.shape
    L = leaf_lo.shape[1]
    expect = (
        ("block_sid", block_sid, torch.int32, (nb,)),
        ("regs", regs, torch.float32, (nb * block_b, k)),
        ("thresholds", thresholds, torch.float32, (S, k, T)),
        ("leaf_lo", leaf_lo, torch.int32, (S, L, k)),
        ("leaf_hi", leaf_hi, torch.int32, (S, L, k)),
        ("leaf_action", leaf_action, torch.int32, (S, L)),
        ("leaf_valid", leaf_valid, torch.int32, (S, L)),
    )
    for name, x, dt, shape in expect:
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dt} {shape} tensor on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty(nb * block_b, dtype=torch.int32, device=dev)
    if nb == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dt_traverse_launch(
        block_sid.data_ptr(), regs.data_ptr(), thresholds.data_ptr(),
        leaf_lo.data_ptr(), leaf_hi.data_ptr(), leaf_action.data_ptr(),
        leaf_valid.data_ptr(), out.data_ptr(), nb, block_b, k, T, L, stream)
    if err != 0:
        msg = lib.dt_traverse_error_string(err).decode()
        raise RuntimeError(f"dt_traverse kernel launch failed: {msg}")
    launches += 1
    return out


def dt_traverse_blocks(block_sid, regs, thresholds, leaf_lo, leaf_hi,
                       leaf_action, leaf_valid, *, block_b: int
                       ) -> torch.Tensor:
    """Block-level range match: kernel B for CUDA tensors, the plain
    version for CPU tensors."""
    fn = dt_traverse_kernel if regs.device.type == "cuda" \
        else dt_traverse_blocks_ref
    return fn(block_sid, regs, thresholds, leaf_lo, leaf_hi, leaf_action,
              leaf_valid, block_b=block_b)
