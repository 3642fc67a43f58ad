"""CUDA kernel A: windowed stateful feature accumulation.

Replaces the Pallas TPU kernel ``feature_window_pallas``
(``src/repro/kernels/feature_window.py``).  The kernel source is
``src/repro_torch/csrc/feature_window.cu``; its plain version is
``repro_torch.kernels.ref.feature_window_ref``, which it must equal bit
for bit.

What bounds it on the H100: device memory.  Every flow's packet window
is read once; at B = 2^20 flows, W = 65, k = 4 the packets are 1.64 GB,
about 0.5 ms at 3.35 TB/s.  The design keeps everything else out of
memory: one thread per (flow, slot) walks the window in order with its
seven running statistics in registers, and the packet tensor is read in
place through its flow stride, so the engine's per-hop view
``win_pkts[:, p]`` costs no copy (a ``.contiguous()`` per hop would move
another 1.6 GB).  The window sums are the strict left-to-right
``ordered_wsum`` chains, spelled with round-to-nearest intrinsics and
built with ``-fmad=false`` (docs/PARITY.md §1).

:func:`feature_window_kernel` only launches: it takes CUDA tensors and
raises on anything else.  ``kernels.ops`` routes a CPU tensor to the
plain version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.features import PKT_NFIELDS

#: kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the main path)
launches = 0

_SOURCE = "feature_window.cu"


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.feature_window_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.feature_window_launch.argtypes = [
            p, ctypes.c_longlong, p, p, p, p, p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, p]
        lib.feature_window_launch.restype = ctypes.c_int
        lib.feature_window_error_string.argtypes = [ctypes.c_int]
        lib.feature_window_error_string.restype = ctypes.c_char_p
    return lib


def _check_slot_rows(name: str, x: torch.Tensor, dtype: torch.dtype,
                     B: int, device: torch.device) -> None:
    if x.device != device or x.dtype != dtype or x.dim() != 2 \
            or x.shape[0] != B or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} (B={B}, k) tensor on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def feature_window_kernel(
    pkts: torch.Tensor,        # (B, W, PKT_NFIELDS) f32, any flow stride
    slot_op: torch.Tensor,     # (B, k) int32 (pre-gathered by SID)
    slot_field: torch.Tensor,  # (B, k) int32
    slot_pred: torch.Tensor,   # (B, k) int32
    slot_init: torch.Tensor,   # (B, k) f32
) -> torch.Tensor:
    """Launch kernel A on the current stream; returns regs (B, k) f32.

    ``pkts`` must have its ``(W, PKT_NFIELDS)`` inner block contiguous;
    its flow stride is passed to the kernel, so a view such as
    ``win_pkts[:, p]`` is read in place.
    """
    global launches
    if pkts.device.type != "cuda":
        raise ValueError(f"feature_window_kernel needs CUDA tensors, got "
                         f"{pkts.device}; kernels.ops routes CPU tensors "
                         "to the plain version")
    if pkts.dtype != torch.float32 or pkts.dim() != 3 \
            or pkts.shape[2] != PKT_NFIELDS:
        raise ValueError(f"pkts: need f32 (B, W, {PKT_NFIELDS}), got "
                         f"{pkts.dtype} {tuple(pkts.shape)}")
    if pkts.stride(2) != 1 or pkts.stride(1) != PKT_NFIELDS:
        raise ValueError("pkts: the (W, fields) block of each flow must be "
                         f"contiguous, got strides {pkts.stride()}")
    B, W, _ = pkts.shape
    if W < 1:
        raise ValueError("pkts: need a window of at least one packet")
    k = slot_op.shape[1] if slot_op.dim() == 2 else -1
    for name, x, dt in (("slot_op", slot_op, torch.int32),
                        ("slot_field", slot_field, torch.int32),
                        ("slot_pred", slot_pred, torch.int32),
                        ("slot_init", slot_init, torch.float32)):
        _check_slot_rows(name, x, dt, B, pkts.device)
        if x.shape[1] != k:
            raise ValueError(f"{name}: need k={k} slots, got {x.shape[1]}")
    out = torch.empty((B, k), dtype=torch.float32, device=pkts.device)
    if B == 0 or k == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(pkts.device).cuda_stream
    err = lib.feature_window_launch(
        pkts.data_ptr(), pkts.stride(0), slot_op.data_ptr(),
        slot_field.data_ptr(), slot_pred.data_ptr(), slot_init.data_ptr(),
        out.data_ptr(), B, W, k, stream)
    if err != 0:
        msg = lib.feature_window_error_string(err).decode()
        raise RuntimeError(f"feature_window kernel launch failed: {msg}")
    launches += 1
    return out
