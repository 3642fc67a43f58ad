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
registers).  Geometry: ``kernels.window.window_geometry``.  The match
runs one thread a flow on shallow subtrees and a warp a flow on deep
ones (the design-space search's models, L up to 704 leaves), chosen from
the tables' L at :data:`WARP_MATCH_MIN_LEAVES`.  Without ``regs_out`` a
flow done before the hop is not walked at all.

Survivor mode (early-exit compaction): given ``rows``, the permutation
of ``kernels.compaction.compact_perm``, and ``n_active``, the device
survivor count, the launch walks only the survivors, reading each one's
window in place; the dense grid is launched and CTAs past the survivors
return at once, so no host sync sizes it.  ``caps``, the plain
version's capacity ladder, is accepted and inert there, as
``EngineOptions.block_b`` is on the walk.

:func:`engine_hop_kernel` only launches: it takes CUDA tensors and
raises on anything else.  :func:`engine_hop_plain` is the plain version
written into the carry in place, on any device: ``step_hop`` of
``ref.fused_step``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import compaction
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ops import StepFn
from repro_torch.kernels.window import check_window_view, window_geometry

#: hop-kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the main path)
launches = 0
#: of those, the launches in survivor mode (with ``rows``)
survivor_launches = 0

_SOURCE = "engine_hop.cu"

#: the least leaves a subtree table (its L, a multiple of 8) may have for
#: the hop to match a flow with a warp's 32 lanes (``warp_first_hit_leaf``)
#: instead of one thread (``first_hit_leaf``).  Measured with
#: ``tools/dse_kernels_ab.py`` on an NVIDIA H100 80GB HBM3 at 700.00 W:
#: the walk of (d, d, d) models over 2^20 flows, with the trace / without,
#: serial against warp in ms: at L = 8, k = 4 2.38 / 2.33 against 2.56 /
#: 2.55, k = 6 2.95 / 2.95 against 3.03 / 3.07; at L = 16, k = 4 2.58 /
#: 2.46 against 2.58 / 2.52, k = 6 3.36 / 3.29 against 3.06 / 3.08; at
#: L = 32 and 64 the warp match takes 9-38% less.  So 16: the serial match only
#: on the 8-leaf tables of ``Engine.run``'s model.
WARP_MATCH_MIN_LEAVES = 16


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.engine_hop_launch.argtypes is None:
        p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.engine_hop_launch.argtypes = (
            [p, n, n] + [i] * 9 + [p] * 9 + [i] * 4 + [p] * 9 + [p])
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
                      regs_out: torch.Tensor | None = None,
                      rows: torch.Tensor | None = None,
                      n_active: torch.Tensor | None = None,
                      caps: tuple[int, ...] | None = None,
                      survivors_out: torch.Tensor | None = None) -> None:
    """Launch the hop kernel on the current stream: hop ``p`` of the walk,
    in place on ``carry``.

    ``pkts`` (B, W, PKT_NFIELDS) f32, the hop's window view (its flow
    stride is passed to the kernel; see
    ``kernels.window.check_window_view``); ``carry`` the walk's
    ``(sid, done, labels, recircs, exit_p)``, int32 (B,) each but ``done``
    bool; ``dev`` the engine's ``DeviceTables``; ``regs_out`` None or an
    f32 (B, k) tensor that receives the registers.  A SID of -1 reads
    table row S - 1 (a negative index); the kernel clamps any other SID
    outside ``[0, S)`` into it and never reads out of bounds.  With
    ``rows`` (int32 (B,)) and ``n_active`` (int32, one element), both on
    the device, the hop runs in survivor mode on flows ``rows[:n_active]``
    only and leaves every other flow's carry and ``regs_out`` row as they
    are; ``caps`` is not read.  Without ``regs_out`` the flows done
    before the hop are not walked (their carry is left as it is).
    ``rows`` and ``n_active`` are
    ``compaction.compact_perm`` of the carry's ``done``, so the flows named
    are the survivors; a count above B reads as B and a row outside
    ``[0, B)`` names no flow.  ``survivors_out`` (int32, one element, on
    the device; a dense hop only) loses the flows done after the hop,
    counted by the launch itself: the walk starts it at B, so it then
    holds the flows still walking.  Raises on CPU
    tensors, on anything else the kernel does not take and on a failed
    launch.
    """
    global launches, survivor_launches
    del caps                          # the plain version's ladder
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
    if (rows is None) != (n_active is None):
        raise ValueError("survivor mode needs both rows and n_active")
    if rows is not None:
        _check("rows", rows, i32, (B,), d)
        _check("n_active", n_active.reshape(1), i32, (1,), d)
    if survivors_out is not None:
        if rows is not None:
            raise ValueError("survivors_out counts a dense hop only")
        _check("survivors_out", survivors_out.reshape(1), i32, (1,), d)
    if B == 0:
        return
    g = window_geometry(B, W, k)
    lib = _lib()
    stream = torch.cuda.current_stream(d).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    err = lib.engine_hop_launch(
        pkts.data_ptr(), pkts.stride(0), B, W, k, g.flows, g.chunk,
        g.stride, g.smem_bytes, g.carveout, p,
        int(L >= WARP_MATCH_MIN_LEAVES), *ptr(*dev), S, T, L,
        n_subtrees,
        *ptr(sid, done, labels, recircs, exit_p),
        None if regs_out is None else regs_out.data_ptr(),
        None if rows is None else rows.data_ptr(),
        None if n_active is None else n_active.data_ptr(),
        None if survivors_out is None else survivors_out.data_ptr(),
        stream)
    if err != 0:
        msg = lib.engine_hop_error_string(err).decode()
        raise RuntimeError(f"engine_hop kernel launch failed: {msg}")
    launches += 1
    if rows is not None:
        survivor_launches += 1


def step_hop(step: StepFn):
    """A walk hop from a partition stage, with :func:`engine_hop_kernel`'s
    arguments: ``step`` on the carry's SIDs, then ``ref.hop_update``,
    written in place (the two-kernel walk is
    ``step_hop(ops.cuda_step(block_b))``).  With ``rows`` and ``n_active``
    (``compaction.compact_perm`` of the carry's ``done``) ``step`` runs on
    the survivors through the plain compacted step on the ladder ``caps``
    (default: ``bucket_caps(B)``), and ``regs_out`` rows of done flows are
    left as they are, as the kernel leaves them.  ``survivors_out`` (a
    dense hop only) loses the flows done after the hop, summed from the
    carry's flags."""
    def hop(pkts, carry, dev, p, *, n_subtrees, regs_out=None, rows=None,
            n_active=None, caps=None, survivors_out=None):
        if survivors_out is not None and rows is not None:
            raise ValueError("survivors_out counts a dense hop only")
        if rows is None:
            regs, action = step(pkts, carry[0], dev)
        else:
            regs, action = compaction.survivor_step(
                pkts, carry[0], carry[1], dev, rows, n_active, step=step,
                caps=caps or compaction.bucket_caps(pkts.shape[0]),
                with_regs=regs_out is not None)
            if regs_out is not None:
                regs = torch.where(carry[1][:, None], regs_out, regs)
        new = _ref.hop_update(carry, p, action, n_subtrees)
        for dst, src in zip(carry, new):
            dst.copy_(src)
        if regs_out is not None:
            regs_out.copy_(regs)
        if survivors_out is not None:
            survivors_out.sub_(torch.sum(carry[1], dtype=torch.int32))
    return hop


#: the hop kernel's plain version: ``ref.engine_hop_ref`` (``fused_step``
#: then ``hop_update``) written into the carry and ``regs_out`` in place
engine_hop_plain = step_hop(_ref.fused_step)
