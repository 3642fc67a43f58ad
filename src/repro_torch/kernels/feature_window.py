"""CUDA feature kernels: the window register fill (kernel A) and the
per-packet fold of live serving (kernels 3 and 4).

Kernel A replaces the Pallas TPU kernel ``feature_window_pallas``
(``src/repro/kernels/feature_window.py``).  The kernel source is
``src/repro_torch/csrc/feature_window.cu``; its plain version is
``repro_torch.kernels.ref.feature_window_ref``, which it must equal bit
for bit.

What bounds kernel A on the H100: device memory.  Every flow's packet
window is read once; at B = 2^20 flows, W = 65, k = 4 the packets are
1.64 GB, about 0.5 ms at 3.35 TB/s.  The design is the window walk of
``csrc/window.cuh``, shared with the hop kernel (``kernels.engine_hop``):
a CTA stages its flows' windows in shared memory with coalesced 8-byte
copies, chunk by chunk and double buffered, and each thread walks one
(flow, slot) pair with its seven running statistics in registers
(geometry: ``kernels.window.window_geometry``).  The packet tensor is
read in place through its flow stride, so a per-hop view
``win_pkts[:, p]`` costs no copy (a ``.contiguous()`` per hop would move
another 1.6 GB).  The window sums are the strict left-to-right
``ordered_wsum`` chains, spelled with round-to-nearest intrinsics and
built with ``-fmad=false`` (docs/PARITY.md §1).  Since the engine's walk
runs the hop kernel, kernel A runs in ``window_features`` (k = 41): one
launch a call over every window, under one slot row all flows share.

The fold kernels (``csrc/feature_update.cu``) replace
``feature_update_pallas`` and ``feature_update_finalize_pallas``.  One
template, one packet per row, one thread per (row, slot), in two forms:
the row forms (:func:`feature_update_kernel`,
:func:`feature_update_finalize_kernel`: the Pallas kernels' dense (n, k)
arguments; plain versions ``ref.feature_update_ref`` and
``ref.feature_update_finalize_ref``) and the table forms
(:func:`feature_update_table_kernel`,
:func:`feature_update_finalize_table_kernel`: the resident (N, k) state
folded in place at ``slots``, the slot rows pre-gathered or read from
the SID-keyed tables at each row's SID; plain versions
:func:`feature_update_table_ref`,
:func:`feature_update_finalize_table_ref`).  An elementwise pass of ~96
bytes a row at k = 4, so at serving widths they are bound by launch
latency, not by memory.

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
from repro_torch.kernels.window import (
    WINDOW_THREADS, check_window_view, window_geometry,
)

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
        n, i = ctypes.c_longlong, ctypes.c_int
        lib.feature_window_launch.argtypes = [
            p, n, p, p, p, p, n, p, n, i, i, i, i, i, i, i, p]
        lib.feature_window_launch.restype = ctypes.c_int
        lib.feature_window_error_string.argtypes = [ctypes.c_int]
        lib.feature_window_error_string.restype = ctypes.c_char_p
        lib.window_threads.argtypes = []
        lib.window_threads.restype = ctypes.c_int
        if lib.window_threads() != WINDOW_THREADS:
            raise RuntimeError(f"csrc/window.cuh runs CTAs of "
                               f"{lib.window_threads()} threads, "
                               f"WINDOW_THREADS is {WINDOW_THREADS}")
    return lib


def _check_slot_rows(name: str, x: torch.Tensor, dtype: torch.dtype,
                     B: int, device: torch.device) -> None:
    if x.device != device or x.dtype != dtype or x.dim() != 2 \
            or x.shape[0] != B or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} (B={B}, k) tensor on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


_SLOT_ROW_DTYPES = (("slot_op", torch.int32), ("slot_field", torch.int32),
                    ("slot_pred", torch.int32), ("slot_init", torch.float32))


def slot_row_stride(B: int, rows: tuple[torch.Tensor, ...],
                    device: torch.device) -> tuple[int, int]:
    """Kernel A's four slot-row arguments ``(slot_op, slot_field,
    slot_pred, slot_init)`` for ``B`` flows: each (B, k), a row a flow, or
    each (1, k), one row every flow shares, contiguous on ``device`` with
    the dtypes the kernel reads.  Returns ``(k, row_stride)``: the stride
    in elements between two flows' rows, k or 0.  Raises ``ValueError``
    on anything else."""
    lead = rows[0].shape[0] if rows[0].dim() == 2 else -1
    if lead not in (1, B):
        raise ValueError(f"slot rows: need (B={B}, k) or (1, k) tensors, "
                         f"got {tuple(rows[0].shape)}")
    k = rows[0].shape[1]
    for (name, dt), x in zip(_SLOT_ROW_DTYPES, rows, strict=True):
        _check_slot_rows(name, x, dt, lead, device)
        if x.shape[1] != k:
            raise ValueError(f"{name}: need k={k} slots, got {x.shape[1]}")
    return k, (0 if lead == 1 else k)


def feature_window_kernel(
    pkts: torch.Tensor,        # (B, W, PKT_NFIELDS) f32, any flow stride
    slot_op: torch.Tensor,     # (B, k) or (1, k) int32
    slot_field: torch.Tensor,  # the same, int32
    slot_pred: torch.Tensor,   # the same, int32
    slot_init: torch.Tensor,   # the same, f32
) -> torch.Tensor:
    """Launch kernel A on the current stream; returns regs (B, k) f32.

    ``pkts`` must have its ``(W, PKT_NFIELDS)`` inner block contiguous
    and be 8-byte aligned with an even flow stride
    (``kernels.window.check_window_view``); its flow stride is passed to
    the kernel, so a view such as ``win_pkts[:, p]`` is read in place.
    The slot rows are (B, k), a row a flow (pre-gathered by SID), or
    (1, k), one row every flow shares (:func:`slot_row_stride`).  Takes k
    up to ``kernels.window.WINDOW_THREADS`` slots.
    """
    global launches
    check_window_view(pkts, "feature_window_kernel")
    rows = (slot_op, slot_field, slot_pred, slot_init)
    k, row_stride = slot_row_stride(pkts.shape[0], rows, pkts.device)
    B, W, _ = pkts.shape
    out = torch.empty((B, k), dtype=torch.float32, device=pkts.device)
    if B == 0 or k == 0:
        return out
    g = window_geometry(B, W, k)
    lib = _lib()
    stream = torch.cuda.current_stream(pkts.device).cuda_stream
    err = lib.feature_window_launch(
        pkts.data_ptr(), pkts.stride(0), *(x.data_ptr() for x in rows),
        row_stride, out.data_ptr(), B, W, k, g.flows, g.chunk, g.stride,
        g.smem_bytes, g.carveout, stream)
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
        lib.feature_update_table_launch.argtypes = [
            p, p, n, p, p, p, p, p, p, p, i, p, i, n, i, p]
        lib.feature_update_table_launch.restype = ctypes.c_int
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


def _sid_rows(rows, sid):
    """The slot rows of each entry: ``rows`` as they are when ``sid`` is
    None, else the SID-keyed tables' rows at ``sid`` (``-1``: row
    ``S - 1``)."""
    if sid is None:
        return rows
    r = sid.to(torch.int64)
    return tuple(t[r] for t in rows)


def feature_update_table_ref(acc_tab, seen_tab, slots, sid, pkt, slot_op,
                             slot_field, slot_pred):
    """Plain version of the fold kernel's table form, as JAX's
    ``feature_update_at`` computes it: every addressed state row
    gathered, folded (``ref.feature_update_ref``), then scattered back
    into ``acc_tab`` / ``seen_tab`` IN PLACE, which it returns.  ``sid``
    None: the slot rows are (n, k), one a row; else they are the (S, k)
    SID-keyed tables, read at each row's SID (``-1``: row ``S - 1``)."""
    s = slots.to(torch.int64)
    rows = _sid_rows((slot_op, slot_field, slot_pred), sid)
    a2, s2 = _ref.feature_update_ref(pkt, *rows, acc_tab[s], seen_tab[s])
    acc_tab[s] = a2
    seen_tab[s] = s2
    return acc_tab, seen_tab


def feature_update_finalize_table_ref(acc_tab, seen_tab, slots, sid, pkt,
                                      slot_op, slot_field, slot_pred,
                                      slot_init):
    """Plain version of the fold-and-finalize kernel's table form:
    :func:`feature_update_table_ref`, then the registers (n, k) of each
    addressed row's new state (``ref.feature_finalize_ref``).  Returns
    ``(acc_tab, seen_tab, regs)``."""
    s = slots.to(torch.int64)
    rows = _sid_rows((slot_op, slot_field, slot_pred, slot_init), sid)
    a2, s2, regs = _ref.feature_update_finalize_ref(
        pkt, *rows, acc_tab[s], seen_tab[s])
    acc_tab[s] = a2
    seen_tab[s] = s2
    return acc_tab, seen_tab, regs


def _check_table(name, acc_tab, seen_tab, slots, sid, pkt, rows) -> int:
    """Validate one table-form launch's tensors; returns k."""
    dev = pkt.device
    if dev.type != "cuda":
        raise ValueError(
            f"{name} needs CUDA tensors, got {dev}; its plain version for "
            f"CPU tensors is {name.replace('_kernel', '_ref')}")
    if pkt.dtype != torch.float32 or pkt.dim() != 2 \
            or pkt.shape[1] != PKT_NFIELDS or not pkt.is_contiguous():
        raise ValueError(f"{name}: pkt needs a contiguous f32 "
                         f"(n, {PKT_NFIELDS}) tensor, got {pkt.dtype} "
                         f"{tuple(pkt.shape)}")
    n = pkt.shape[0]
    k = acc_tab.shape[1] if acc_tab.dim() == 2 else -1
    N = acc_tab.shape[0]
    lead = n if sid is None else rows[0][1].shape[0]
    expect = [("acc_tab", acc_tab, torch.float32, (N, k)),
              ("seen_tab", seen_tab, torch.int32, (N, k)),
              ("slots", slots, torch.int32, (n,))]
    if sid is not None:
        expect.append(("sid", sid, torch.int32, (n,)))
    expect += [(row_name, x, dt, (lead, k)) for row_name, x, dt in rows]
    for arg, x, dt, shape in expect:
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{name}: {arg} needs a contiguous {dt} {shape} tensor on "
                f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if sid is not None and lead == 0 and n:
        raise ValueError(f"{name}: the slot tables hold no subtree")
    return k


def _table_launch(acc_tab, seen_tab, slots, sid, pkt, rows, regs, k):
    lib = _update_lib()
    stream = torch.cuda.current_stream(pkt.device).cuda_stream
    init = rows[3].data_ptr() if len(rows) == 4 else None
    err = lib.feature_update_table_launch(
        acc_tab.data_ptr(), seen_tab.data_ptr(), acc_tab.shape[0],
        slots.data_ptr(), None if sid is None else sid.data_ptr(),
        pkt.data_ptr(), *(x.data_ptr() for x in rows[:3]), init,
        rows[0].shape[0], None if regs is None else regs.data_ptr(),
        int(regs is not None), pkt.shape[0], k, stream)
    _raise_on(lib, err, "feature_update_table")


def feature_update_table_kernel(acc_tab, seen_tab, slots, sid, pkt,
                                slot_op, slot_field, slot_pred):
    """Launch the fold kernel's table form on the current stream
    (arguments as :func:`feature_update_table_ref`; ``slots`` and ``sid``
    int32): ``acc_tab`` / ``seen_tab`` folded IN PLACE at ``slots``, and
    returned.  ``slots`` addresses each row at most once, but for
    duplicates that carry an invalid packet (the flow table's dummy-row
    padding), whose fold is idempotent (``csrc/feature_update.cu``)."""
    global update_launches
    k = _check_table("feature_update_table_kernel", acc_tab, seen_tab,
                     slots, sid, pkt, (
                         ("slot_op", slot_op, torch.int32),
                         ("slot_field", slot_field, torch.int32),
                         ("slot_pred", slot_pred, torch.int32)))
    if pkt.shape[0] and k:
        _table_launch(acc_tab, seen_tab, slots, sid, pkt,
                      (slot_op, slot_field, slot_pred), None, k)
        update_launches += 1
    return acc_tab, seen_tab


def feature_update_finalize_table_kernel(acc_tab, seen_tab, slots, sid, pkt,
                                         slot_op, slot_field, slot_pred,
                                         slot_init):
    """Launch the fold-and-finalize kernel's table form on the current
    stream (arguments as :func:`feature_update_finalize_table_ref`):
    returns ``(acc_tab, seen_tab, regs)``, the tables folded in place."""
    global update_finalize_launches
    k = _check_table("feature_update_finalize_table_kernel", acc_tab,
                     seen_tab, slots, sid, pkt, (
                         ("slot_op", slot_op, torch.int32),
                         ("slot_field", slot_field, torch.int32),
                         ("slot_pred", slot_pred, torch.int32),
                         ("slot_init", slot_init, torch.float32)))
    regs = torch.empty((pkt.shape[0], max(k, 0)), dtype=torch.float32,
                       device=pkt.device)
    if regs.numel():
        _table_launch(acc_tab, seen_tab, slots, sid, pkt,
                      (slot_op, slot_field, slot_pred, slot_init), regs, k)
        update_finalize_launches += 1
    return acc_tab, seen_tab, regs


def feature_update_at(
    acc_tab: torch.Tensor,     # (N, k) f32 resident state table
    seen_tab: torch.Tensor,    # (N, k) int32
    slots: torch.Tensor,       # (n,) int UNIQUE row indices into the table
    pkt: torch.Tensor,         # (n, PKT_NFIELDS) f32
    slot_op: torch.Tensor,     # (n, k) int32, gathered for each slot's SID
    slot_field: torch.Tensor,
    slot_pred: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one packet into each addressed table row, IN PLACE; returns
    ``acc_tab`` / ``seen_tab``.

    A CUDA table takes one launch of the fold kernel's table form, the
    pre-gathered slot rows read as an n-row table indexed by row
    (``sid`` None; one kernel node for int32 ``slots``).  A CPU table
    gathers the rows, folds them with the plain version and scatters
    them back, as JAX does.  ``slots`` must address each real row at
    most once; duplicate padding indices are safe when they carry an
    invalid packet, as the flow table's do: the JAX route computes
    identical values for them, and the kernel's in-place fold of such a
    packet is idempotent.  (The legacy tick engine's ``_fold_rank`` calls
    the SID-keyed table form, :func:`feature_update_table_kernel`, and
    skips the slot-row gathers too.)"""
    if acc_tab.device.type == "cuda":
        return feature_update_table_kernel(
            acc_tab, seen_tab, slots.to(torch.int32), None, pkt, slot_op,
            slot_field, slot_pred)
    return feature_update_table_ref(acc_tab, seen_tab, slots, None, pkt,
                                    slot_op, slot_field, slot_pred)
