"""CUDA feature kernels: the window register fill (kernel A) and the
per-packet fold of live serving (kernels 3 and 4).

Kernel A replaces the Pallas TPU kernel ``feature_window_pallas``
(``src/repro/kernels/feature_window.py``).  The kernel source is
``src/repro_torch/csrc/feature_window.cu``; its plain version is
``repro_torch.kernels.ref.feature_window_ref``, which it must equal bit
for bit.

What bounds kernel A on the H100: device memory.  Every flow's packet
window is read once; at B = 2^20 flows, W = 65, k = 4 the packets are
1.64 GB, about 0.5 ms at 3.35 TB/s.  The design keeps everything else
out of memory: one thread per (flow, slot) walks the window in order
with its seven running statistics in registers, and the packet tensor
is read in place through its flow stride, so the engine's per-hop view
``win_pkts[:, p]`` costs no copy (a ``.contiguous()`` per hop would move
another 1.6 GB).  The window sums are the strict left-to-right
``ordered_wsum`` chains, spelled with round-to-nearest intrinsics and
built with ``-fmad=false`` (docs/PARITY.md §1).

The fold kernels (``csrc/feature_update.cu``) replace
``feature_update_pallas`` and ``feature_update_finalize_pallas``; their
plain versions are ``ref.feature_update_ref`` and
``ref.feature_update_finalize_ref``.  One packet per row, one thread
per (row, slot): an elementwise pass of ~170 bytes a row at k = 4, so at
serving widths they are bound by launch latency, not by memory.

The ``*_kernel`` functions only launch: they take CUDA tensors and raise
on anything else.  ``kernels.ops`` routes a CPU tensor to the plain
version instead, and :func:`feature_update_at` routes by the table's
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.features import PKT_NFIELDS
from repro_torch.kernels import ref as _ref

#: kernel launches since the last reset (``chip_smoke.py`` zeroes each
#: before driving the path that runs it): kernel A, the fold kernel
#: (kernel 3) and the fold-and-finalize kernel (kernel 4)
launches = 0
update_launches = 0
update_finalize_launches = 0

_SOURCE = "feature_window.cu"
_UPDATE_SOURCE = "feature_update.cu"


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


# ---------------------------------------------------------------------------
# the per-packet fold (flow-table serving)
# ---------------------------------------------------------------------------
def _update_lib():
    from repro_torch.kernels import _build
    lib = _build.load(_UPDATE_SOURCE)
    if lib.feature_update_launch.argtypes is None:
        p = ctypes.c_void_p
        n = ctypes.c_longlong
        i = ctypes.c_int
        lib.feature_update_launch.argtypes = [p, p, p, p, p, p, p, p,
                                              n, i, p]
        lib.feature_update_launch.restype = ctypes.c_int
        lib.feature_update_finalize_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, n, i, p]
        lib.feature_update_finalize_launch.restype = ctypes.c_int
        lib.feature_update_error_string.argtypes = [ctypes.c_int]
        lib.feature_update_error_string.restype = ctypes.c_char_p
    return lib


def _check_fold(name: str, pkt: torch.Tensor, rows) -> int:
    """Validate one fold launch's tensors; returns k."""
    if pkt.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {pkt.device}; "
                         "kernels.ops routes CPU tensors to the plain "
                         "version")
    if pkt.dtype != torch.float32 or pkt.dim() != 2 \
            or pkt.shape[1] != PKT_NFIELDS or not pkt.is_contiguous():
        raise ValueError(f"pkt: need a contiguous f32 (n, {PKT_NFIELDS}) "
                         f"tensor, got {pkt.dtype} {tuple(pkt.shape)}")
    n = pkt.shape[0]
    k = rows[0][1].shape[1] if rows[0][1].dim() == 2 else -1
    for row_name, x, dt in rows:
        _check_slot_rows(row_name, x, dt, n, pkt.device)
        if x.shape[1] != k:
            raise ValueError(f"{row_name}: need k={k} slots, got "
                             f"{x.shape[1]}")
    return k


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.feature_update_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def feature_update_kernel(
    pkt: torch.Tensor,         # (n, PKT_NFIELDS) f32, ONE packet per row
    slot_op: torch.Tensor,     # (n, k) int32 (pre-gathered by SID)
    slot_field: torch.Tensor,  # (n, k) int32
    slot_pred: torch.Tensor,   # (n, k) int32
    acc: torch.Tensor,         # (n, k) f32 running window state
    seen: torch.Tensor,        # (n, k) int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fold kernel on the current stream; returns the new
    ``(acc, seen)``, equal to ``ref.feature_update_ref``."""
    global update_launches
    k = _check_fold("feature_update_kernel", pkt, (
        ("slot_op", slot_op, torch.int32),
        ("slot_field", slot_field, torch.int32),
        ("slot_pred", slot_pred, torch.int32),
        ("acc", acc, torch.float32), ("seen", seen, torch.int32)))
    acc2, seen2 = torch.empty_like(acc), torch.empty_like(seen)
    if acc.numel() == 0:
        return acc2, seen2
    lib = _update_lib()
    stream = torch.cuda.current_stream(pkt.device).cuda_stream
    err = lib.feature_update_launch(
        pkt.data_ptr(), slot_op.data_ptr(), slot_field.data_ptr(),
        slot_pred.data_ptr(), acc.data_ptr(), seen.data_ptr(),
        acc2.data_ptr(), seen2.data_ptr(), pkt.shape[0], k, stream)
    _raise_on(lib, err, "feature_update")
    update_launches += 1
    return acc2, seen2


def feature_update_finalize_kernel(
    pkt: torch.Tensor,         # (n, PKT_NFIELDS) f32, ONE packet per row
    slot_op: torch.Tensor,     # (n, k) int32 (pre-gathered by SID)
    slot_field: torch.Tensor,  # (n, k) int32
    slot_pred: torch.Tensor,   # (n, k) int32
    slot_init: torch.Tensor,   # (n, k) f32 (MIN's empty-window fallback)
    acc: torch.Tensor,         # (n, k) f32 running window state
    seen: torch.Tensor,        # (n, k) int32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the fold-and-finalize kernel on the current stream; returns
    ``(acc2, seen2, regs)``, equal to ``ref.feature_update_finalize_ref``."""
    global update_finalize_launches
    k = _check_fold("feature_update_finalize_kernel", pkt, (
        ("slot_op", slot_op, torch.int32),
        ("slot_field", slot_field, torch.int32),
        ("slot_pred", slot_pred, torch.int32),
        ("slot_init", slot_init, torch.float32),
        ("acc", acc, torch.float32), ("seen", seen, torch.int32)))
    acc2, seen2 = torch.empty_like(acc), torch.empty_like(seen)
    regs = torch.empty_like(acc)
    if acc.numel() == 0:
        return acc2, seen2, regs
    lib = _update_lib()
    stream = torch.cuda.current_stream(pkt.device).cuda_stream
    err = lib.feature_update_finalize_launch(
        pkt.data_ptr(), slot_op.data_ptr(), slot_field.data_ptr(),
        slot_pred.data_ptr(), slot_init.data_ptr(), acc.data_ptr(),
        seen.data_ptr(), acc2.data_ptr(), seen2.data_ptr(), regs.data_ptr(),
        pkt.shape[0], k, stream)
    _raise_on(lib, err, "feature_update_finalize")
    update_finalize_launches += 1
    return acc2, seen2, regs


def feature_update_at(
    acc_tab: torch.Tensor,     # (N, k) f32 resident state table
    seen_tab: torch.Tensor,    # (N, k) int32
    slots: torch.Tensor,       # (n,) int UNIQUE row indices into the table
    pkt: torch.Tensor,         # (n, PKT_NFIELDS) f32
    slot_op: torch.Tensor,     # (n, k) int32, gathered for each slot's SID
    slot_field: torch.Tensor,
    slot_pred: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one packet into each addressed table row, IN PLACE.

    Gathers the rows, folds (the fold kernel for a CUDA table, the plain
    version for a CPU one) and scatters the new state back into
    ``acc_tab`` / ``seen_tab``, which it returns.  ``slots`` must
    address each real row at most once; duplicate padding indices are
    safe, since padded rows compute identical values."""
    s = slots.to(torch.int64)
    fold = (feature_update_kernel if acc_tab.device.type == "cuda"
            else _ref.feature_update_ref)
    a2, s2 = fold(pkt, slot_op, slot_field, slot_pred, acc_tab[s],
                  seen_tab[s])
    acc_tab[s] = a2
    seen_tab[s] = s2
    return acc_tab, seen_tab
