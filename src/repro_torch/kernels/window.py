"""Launch geometry of the window walk shared by kernel A and the hop
kernel (``csrc/window.cuh``), and the checks on the window view both
take.

A CTA of :data:`WINDOW_THREADS` threads owns ``flows = 256 // k``
consecutive flows, one thread per (flow, slot) pair, and stages their
windows in shared memory ``chunk`` packets at a time, in a ring of
:data:`STAGES` buffers (the next chunk is copied while one is walked; one
buffer where a single chunk makes the window).  ``chunk`` is chosen so a
staged chunk of the tile holds about :data:`STAGE_BYTES`: at k = 4, 64
flows of 8 packets (12.3 KB).  The 8-byte copies pass through L1, so
the launch asks for a shared-memory carveout that fits only
``ctas_per_sm`` CTAs and leaves L1 at least twice the bytes they have in
flight (one chunk each): at k = 4, four CTAs of 30 KB, ~49 KB in flight
against ~124 KB of L1 (device memory's latency times its rate needs
~25 KB an SM).  With the default carveout the hop kernel, whose 32
registers let seven CTAs share an SM, left L1 too small for its copies
and ran markedly slower on the H100.  In shared memory a flow's chunk
takes ``stride`` floats, ``6 * chunk`` padded to an odd number of 8-byte
words, so neighbouring flows start in different banks; each staged
packet's predicate bits take one word of a row of ``chunk | 1`` (odd, for
the same reason).

The copies are 8 bytes wide, so the view need only be 8-byte aligned: the
engine's hop view ``win_pkts[:, p]`` of a (B, P', 65, 6) tensor has a flow
stride of 4,680 bytes at P' = 3, which puts every other flow's window at
8 mod 16, where 16-byte copies would need an unaligned head and tail.

Everything here is plain Python over shapes, so the CPU tests check it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.features import PKT_NFIELDS

#: threads of a CTA (``csrc/window.cuh`` kWindowThreads); also the
#: largest k the window kernels take (one thread per slot of a flow)
WINDOW_THREADS = 256
#: target bytes of one staged chunk of a CTA's flows
STAGE_BYTES = 12288
#: buffers of the staging ring (``csrc/window.cuh`` kStages)
STAGES = 2
_PKT_BYTES = 4 * PKT_NFIELDS
# the H100's SM: its unified L1 and shared memory, the most of it that
# can be shared, the shared memory the system keeps a CTA, and the CTAs
# of WINDOW_THREADS that its 2,048 threads allow
_SM_BYTES = 256 * 1024
_SMEM_MAX = 228 * 1024
_CTA_RESERVED = 1024
_MAX_CTAS = 2048 // WINDOW_THREADS


class WindowGeometry(NamedTuple):
    flows: int        # flows a CTA
    chunk: int        # packets a staged chunk
    stride: int       # floats a flow's chunk takes in shared memory
    n_chunks: int     # chunks a window
    ctas: int         # CTAs of the launch
    smem_bytes: int   # staging buffers, predicate words, marks
    ctas_per_sm: int  # CTAs the carveout fits
    carveout: int     # percent of _SMEM_MAX asked for shared memory


def window_geometry(B: int, W: int, k: int) -> WindowGeometry:
    """The launch of a window kernel over ``B`` flows of ``W`` packets
    and ``k`` slots."""
    if not 1 <= k <= WINDOW_THREADS:
        raise ValueError(f"the window kernels take k in 1..{WINDOW_THREADS} "
                         f"slots, got k={k}")
    if W < 1:
        raise ValueError("need a window of at least one packet")
    flows = WINDOW_THREADS // k
    chunk = max(1, min(W, STAGE_BYTES // (flows * _PKT_BYTES)))
    stride = PKT_NFIELDS * chunk + (2 if chunk % 2 == 0 else 0)
    n_chunks = -(-W // chunk)
    buffers = min(n_chunks, STAGES)
    smem = 4 * (buffers * flows * stride + flows * (chunk | 1) + flows * k)
    # a CTA takes its shared memory and twice its chunk in flight of L1
    per_cta = smem + _CTA_RESERVED + 2 * flows * chunk * _PKT_BYTES
    ctas = max(1, min(_MAX_CTAS, _SM_BYTES // per_cta))
    carveout = min(100, -(-100 * ctas * (smem + _CTA_RESERVED)
                           // _SMEM_MAX))
    return WindowGeometry(flows=flows, chunk=chunk, stride=stride,
                          n_chunks=n_chunks, ctas=-(-B // flows),
                          smem_bytes=smem, ctas_per_sm=ctas,
                          carveout=carveout)


def check_window_view(pkts: torch.Tensor, name: str) -> None:
    """What the window kernels read: an f32 (B, W, 6) CUDA tensor whose
    (W, 6) block of each flow is dense, 8-byte aligned with an even flow
    stride (the 8-byte copies).  Raises ``ValueError`` otherwise."""
    if pkts.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {pkts.device}; "
                         "kernels.ops routes CPU tensors to the plain "
                         "version")
    if pkts.dtype != torch.float32 or pkts.dim() != 3 \
            or pkts.shape[2] != PKT_NFIELDS:
        raise ValueError(f"pkts: need f32 (B, W, {PKT_NFIELDS}), got "
                         f"{pkts.dtype} {tuple(pkts.shape)}")
    if pkts.stride(2) != 1 or pkts.stride(1) != PKT_NFIELDS:
        raise ValueError("pkts: the (W, fields) block of each flow must be "
                         f"contiguous, got strides {pkts.stride()}")
    if pkts.data_ptr() % 8 or pkts.stride(0) % 2:
        raise ValueError("pkts: the kernel copies 8-byte words and needs an "
                         "8-byte-aligned view with an even flow stride, got "
                         f"address {pkts.data_ptr()} and strides "
                         f"{pkts.stride()}")
