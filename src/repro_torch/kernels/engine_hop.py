"""The hop kernel: one hop of the engine's partition walk in one launch.

Replaces, on ``Engine.run``'s card route, the per-hop pair of the Pallas
TPU kernels ``feature_window_pallas`` and ``dt_traverse_pallas`` (behind
the SID dispatch) and the walk's ``_hop_update``.  The kernel source is
``src/repro_torch/csrc/engine_hop.cu``; its plain version is
``ref.engine_hop_ref`` (``fused_step`` then ``hop_update``), which it must
equal bit for bit on the registers and every carry field.

For every flow the launch reads the flow's SID, that SID's slot rows
from the ``(S, k)`` tables (no ``(B, k)`` gathers), walks the window
through its flow stride into the k registers (``csrc/window.cuh``, the
walk kernel A shares), range-matches them against the SID's subtree
and updates the carry ``(sid, done, labels, recircs, exit_p)`` in place;
with ``regs_out`` it also writes the registers there (the walk's trace).
No SID dispatch: no argsort, no ``index_add_``, no capacity blocks.

What bounds it on the H100: device memory, ~0.5 ms a hop at B = 2^20,
W = 65, k = 4 (1.64 GB of windows, ~34 MB of carry, 17 MB of
registers).  Geometry: ``kernels.window.window_geometry``.

:func:`engine_hop_kernel` only launches: it takes CUDA tensors and
raises on anything else.  :func:`engine_hop_plain` is the plain version
written into the carry in place, on any device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.window import check_window_view, window_geometry

#: hop-kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the main path)
launches = 0

_SOURCE = "engine_hop.cu"


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.engine_hop_launch.argtypes is None:
        p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.engine_hop_launch.argtypes = (
            [p, n, n] + [i] * 8 + [p] * 9 + [i] * 4 + [p] * 6 + [p])
        lib.engine_hop_launch.restype = ctypes.c_int
        lib.engine_hop_error_string.argtypes = [ctypes.c_int]
        lib.engine_hop_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(
            f"{name}: need a contiguous {dtype} {shape} tensor on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def engine_hop_kernel(pkts: torch.Tensor, carry, dev, p: int, *,
                      n_subtrees: int,
                      regs_out: torch.Tensor | None = None) -> None:
    """Launch the hop kernel on the current stream: hop ``p`` of the walk,
    in place on ``carry``.

    ``pkts`` (B, W, PKT_NFIELDS) f32, the hop's window view (its flow
    stride is passed to the kernel; see
    ``kernels.window.check_window_view``); ``carry`` the walk's
    ``(sid, done, labels, recircs, exit_p)``, int32 (B,) each but ``done``
    bool; ``dev`` the engine's ``DeviceTables``; ``regs_out`` None or an
    f32 (B, k) tensor that receives the registers.  A SID of -1 reads
    table row S - 1 (a negative index); the kernel clamps any other SID
    outside ``[0, S)`` into it and never reads out of bounds.  Raises on
    CPU tensors, on anything else the kernel does not take and on a
    failed launch.
    """
    global launches
    check_window_view(pkts, "engine_hop_kernel")
    d = pkts.device
    B, W, _ = pkts.shape
    S, k, T = dev.thresholds.shape
    L = dev.leaf_lo.shape[1]
    i32, f32 = torch.int32, torch.float32
    sid, done, labels, recircs, exit_p = carry
    for name, x, dt, shape in (
            ("sid", sid, i32, (B,)), ("done", done, torch.bool, (B,)),
            ("labels", labels, i32, (B,)), ("recircs", recircs, i32, (B,)),
            ("exit_p", exit_p, i32, (B,)),
            ("slot_op", dev.slot_op, i32, (S, k)),
            ("slot_field", dev.slot_field, i32, (S, k)),
            ("slot_pred", dev.slot_pred, i32, (S, k)),
            ("slot_init", dev.slot_init, f32, (S, k)),
            ("thresholds", dev.thresholds, f32, (S, k, T)),
            ("leaf_lo", dev.leaf_lo, i32, (S, L, k)),
            ("leaf_hi", dev.leaf_hi, i32, (S, L, k)),
            ("leaf_action", dev.leaf_action, i32, (S, L)),
            ("leaf_valid", dev.leaf_valid, i32, (S, L))):
        _check(name, x, dt, shape, d)
    if regs_out is not None:
        _check("regs_out", regs_out, f32, (B, k), d)
    if B == 0:
        return
    g = window_geometry(B, W, k)
    lib = _lib()
    stream = torch.cuda.current_stream(d).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    err = lib.engine_hop_launch(
        pkts.data_ptr(), pkts.stride(0), B, W, k, g.flows, g.chunk,
        g.stride, g.smem_bytes, g.carveout, p, *ptr(*dev), S, T, L,
        n_subtrees,
        *ptr(sid, done, labels, recircs, exit_p),
        None if regs_out is None else regs_out.data_ptr(), stream)
    if err != 0:
        msg = lib.engine_hop_error_string(err).decode()
        raise RuntimeError(f"engine_hop kernel launch failed: {msg}")
    launches += 1


def engine_hop_plain(pkts: torch.Tensor, carry, dev, p: int, *,
                     n_subtrees: int,
                     regs_out: torch.Tensor | None = None) -> None:
    """The hop kernel's plain version, in place: ``ref.engine_hop_ref``
    written into ``carry`` (and ``regs_out``), on any device."""
    new, regs = _ref.engine_hop_ref(pkts, carry, dev, p, n_subtrees)
    write_hop(carry, new, regs, regs_out)


def write_hop(carry, new, regs: torch.Tensor,
              regs_out: torch.Tensor | None) -> None:
    """Copy a functional hop's results into the walk's tensors."""
    for dst, src in zip(carry, new):
        dst.copy_(src)
    if regs_out is not None:
        regs_out.copy_(regs)
