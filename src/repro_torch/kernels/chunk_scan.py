"""CUDA kernel: the chunked gated linear recurrence (RWKV6 / GLA).

Replaces the Pallas TPU kernel ``chunk_scan_pallas``
(``src/repro/kernels/chunk_scan.py``).  The kernel source is
``src/repro_torch/csrc/chunk_scan.cu``; its plain version is
``repro_torch.kernels.ref.chunk_scan_chunked_ref``, which it must match
within the tolerances of ``tests/test_kernels.py`` (o within
2e-4 * max(|o|, 1), the state within 3e-4).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    GLA form:            o_t = q_t S_t
    bonus (RWKV6) form:  o_t = q_t (S_{t-1} + diag(u) k_t^T v_t)

Design (the source's head note has the details): only the (dk x dv)
state recurrence is sequential across chunks, so a call of C >= 2 is
three launches -- one per chunk that computes its prefix once, the
output kernel's operands and its state contribution; one in-order pass
over the chunks that leaves the state entering each chunk in scratch;
one per chunk and 64-row tile that computes the output -- with the four
products on the tensor cores in split TF32 (three TF32 products per f32
product: 1xTF32 misses the tolerance, ``tests/test_torch_lm.py`` shows
why).  A decode step (C == 1) is one launch of a one-step kernel on the
CUDA cores.  What bounds it at the prefill shape: bytes just ahead of
split-TF32 operations; in practice the latency and instruction
throughput of each CTA's phases.  :func:`chunk_scan_kernel` only
launches: it takes CUDA tensors and raises on anything else.  ``kernels.ops.chunk_scan`` pads T,
defaults the state and the bonus, and routes a CPU tensor to the plain
version instead.
"""
from __future__ import annotations

import ctypes

import torch

#: the chunk length ``ops.chunk_scan`` defaults to
DEFAULT_CHUNK = 128

#: calls that launched the kernel since the last reset (``chip_smoke.py``
#: zeroes it before driving the LM path)
launches = 0
#: device kernels those calls launched, counted by the library at each
#: ``<<<>>>`` that succeeded (3 a call for C >= 2, 1 for C == 1)
kernel_launches = 0

_SOURCE = "chunk_scan.cu"
MAX_CHUNK = 128          # the largest att tile of the output kernel
MAX_DK = 128


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load(_SOURCE)
    if lib.chunk_scan_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.chunk_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, p,
                                          ctypes.POINTER(i)]
        lib.chunk_scan_scratch_floats.argtypes = [i, i, i, i, i]
        lib.chunk_scan_scratch_floats.restype = ctypes.c_longlong
        lib.chunk_scan_launch.restype = ctypes.c_int
        lib.chunk_scan_resources.argtypes = [i, i, i, i, p]
        lib.chunk_scan_resources.restype = ctypes.c_int
        lib.chunk_scan_error_string.argtypes = [ctypes.c_int]
        lib.chunk_scan_error_string.restype = ctypes.c_char_p
    return lib


def resources(C: int, dk: int, dv: int, use_bonus: bool) -> dict:
    """Dynamic shared memory (bytes) and resident CTAs per SM of the
    chunk-parallel prep and output kernels at one shape (call after a
    launch at that shape, which raises the shared-memory ceiling)."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    err = lib.chunk_scan_resources(C, dk, dv, int(bool(use_bonus)), out)
    if err != 0:
        raise RuntimeError("chunk_scan resources: "
                           + lib.chunk_scan_error_string(err).decode())
    return {"prep_kernel_smem_bytes": out[0],
            "out_kernel_smem_bytes": out[1],
            "prep_kernel_ctas_per_sm": out[2],
            "out_kernel_ctas_per_sm": out[3]}


def chunk_scan_kernel(
    q: torch.Tensor,       # (B, T, dk) f32
    k: torch.Tensor,       # (B, T, dk) f32
    v: torch.Tensor,       # (B, T, dv) f32
    decay: torch.Tensor,   # (B, T, dk) f32 in (0, 1]
    bonus: torch.Tensor,   # (B, dk) f32 (read only if use_bonus)
    state: torch.Tensor,   # (B, dk, dv) f32 initial state
    *,
    chunk: int,
    use_bonus: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; returns
    ``(o (B, T, dv), final_state (B, dk, dv))``, both f32.

    ``C = min(chunk, T)`` must divide T (``ops.chunk_scan`` pads);
    C <= 128, dk a multiple of 4 up to 128.
    """
    global launches, kernel_launches
    if q.device.type != "cuda":
        raise ValueError(f"chunk_scan_kernel needs CUDA tensors, got "
                         f"{q.device}; kernels.ops.chunk_scan routes CPU "
                         "tensors to the plain version")
    if q.dim() != 3:
        raise ValueError(f"q: need (B, T, dk), got {tuple(q.shape)}")
    B, T, dk = q.shape
    dv = v.shape[-1] if v.dim() == 3 else -1
    want = {"q": (q, (B, T, dk)), "k": (k, (B, T, dk)),
            "v": (v, (B, T, dv)), "decay": (decay, (B, T, dk)),
            "bonus": (bonus, (B, dk)), "state": (state, (B, dk, dv))}
    for name, (x, shape) in want.items():
        if x.device != q.device or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous float32 {shape} tensor on "
                f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if T < 1 or dv < 1:
        raise ValueError(f"need T >= 1 and dv >= 1, got T={T}, dv={dv}")
    C = min(chunk, T)
    if T % C != 0:
        raise ValueError(f"T={T} must be a multiple of chunk={C}")
    if C > MAX_CHUNK:
        raise ValueError(f"chunk={C}: the kernel takes chunks of at most "
                         f"{MAX_CHUNK}")
    if dk % 4 != 0 or dk > MAX_DK:
        raise ValueError(f"dk={dk}: the kernel takes a multiple of 4 up to "
                         f"{MAX_DK}")
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((B, T, dv), **f32)
    s_out = torch.empty((B, dk, dv), **f32)
    if B == 0:
        return o, s_out
    lib = _lib()
    # scratch of the chunk-parallel route (the source says what it holds)
    scratch = torch.empty(lib.chunk_scan_scratch_floats(B, T, dk, dv, C),
                          **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launched = ctypes.c_int(0)
    err = lib.chunk_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), decay.data_ptr(),
        bonus.data_ptr(), state.data_ptr(), o.data_ptr(), s_out.data_ptr(),
        scratch.data_ptr(), B, T, dk, dv, C, int(bool(use_bonus)), stream,
        ctypes.byref(launched))
    kernel_launches += launched.value
    if err != 0:
        msg = lib.chunk_scan_error_string(err).decode()
        raise RuntimeError(f"chunk_scan kernel launch failed (B={B}, T={T}, "
                           f"dk={dk}, dv={dv}, C={C}): {msg}")
    launches += 1
    return o, s_out
