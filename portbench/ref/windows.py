"""Frozen NumPy copy of SpliDT's windows and window features.

A flow of L packets is cut into P uniform windows of ``L // P`` packets,
the remainder to the last; each window is padded to W packets (valid 0)
and its first packet's inter-arrival time is cleared.  A window's
features are CICFlowMeter-style statistics, each an (op, field,
predicate) triple of the paper's Fig. 4.

The arithmetic is the data plane's, in f32: counts, sums and sums of
squares are strict left-to-right chains starting from the first packet
(``((x0 + x1) + x2) + ...``), a square is ``(v * v) * mask``, MAX / MIN
fall back to 0 / the f32 maximum on an empty window.  ``rnd`` rounds
every input and every intermediate result: the identity for the f32
reference, :func:`bf16` for the lower-precision control.
"""
from __future__ import annotations

import numpy as np

from .flows import DIR, FLAGS, IAT, N_FIELDS, SIZE, TS, VALID

# op codes
COUNT, SUM, MAX, MIN, LAST, SUMSQ, FIRST = 1, 2, 3, 4, 5, 6, 7
# predicate codes: all, forward, backward, then flag bits
P_TRUE, P_FWD, P_BWD = 0, 1, 2
_PRED_FLAG = {3: 1, 4: 2, 5: 4, 6: 8, 7: 16, 8: 32}

F32_MAX = np.float32(np.finfo(np.float32).max)

#: the 41 features: (name, op, field, predicate), in feature-id order
FEATURES = (
    ("pkt_count", COUNT, SIZE, P_TRUE), ("byte_sum", SUM, SIZE, P_TRUE),
    ("pkt_size_max", MAX, SIZE, P_TRUE), ("pkt_size_min", MIN, SIZE, P_TRUE),
    ("pkt_size_sumsq", SUMSQ, SIZE, P_TRUE),
    ("pkt_size_first", FIRST, SIZE, P_TRUE),
    ("pkt_size_last", LAST, SIZE, P_TRUE),
    ("fwd_pkt_count", COUNT, SIZE, P_FWD), ("bwd_pkt_count", COUNT, SIZE, P_BWD),
    ("fwd_byte_sum", SUM, SIZE, P_FWD), ("bwd_byte_sum", SUM, SIZE, P_BWD),
    ("fwd_size_max", MAX, SIZE, P_FWD), ("bwd_size_max", MAX, SIZE, P_BWD),
    ("fwd_size_min", MIN, SIZE, P_FWD), ("bwd_size_min", MIN, SIZE, P_BWD),
    ("iat_sum", SUM, IAT, P_TRUE), ("iat_max", MAX, IAT, P_TRUE),
    ("iat_min", MIN, IAT, P_TRUE), ("iat_sumsq", SUMSQ, IAT, P_TRUE),
    ("fwd_iat_sum", SUM, IAT, P_FWD), ("bwd_iat_sum", SUM, IAT, P_BWD),
    ("fwd_iat_max", MAX, IAT, P_FWD), ("bwd_iat_max", MAX, IAT, P_BWD),
    ("syn_count", COUNT, SIZE, 3), ("ack_count", COUNT, SIZE, 4),
    ("fin_count", COUNT, SIZE, 5), ("rst_count", COUNT, SIZE, 6),
    ("psh_count", COUNT, SIZE, 7), ("urg_count", COUNT, SIZE, 8),
    ("syn_size_sum", SUM, SIZE, 3), ("psh_size_sum", SUM, SIZE, 7),
    ("ack_size_max", MAX, SIZE, 4),
    ("ts_first", FIRST, TS, P_TRUE), ("ts_last", LAST, TS, P_TRUE),
    ("syn_iat_sum", SUM, IAT, 3), ("psh_iat_max", MAX, IAT, 7),
    ("fwd_psh_count", COUNT, SIZE, 7), ("bwd_ack_count", COUNT, SIZE, 4),
    ("fwd_size_sumsq", SUMSQ, SIZE, P_FWD),
    ("bwd_size_sumsq", SUMSQ, SIZE, P_BWD),
    ("bwd_size_last", LAST, SIZE, P_BWD),
)
N_FEATURES = len(FEATURES)


def window_bounds(length: int, p: int) -> list[tuple[int, int]]:
    base = max(length // p, 1)
    out = []
    for w in range(p):
        lo = min(w * base, length)
        hi = length if w == p - 1 else min((w + 1) * base, length)
        out.append((lo, hi))
    return out


def window_lengths(lengths: np.ndarray, p: int) -> np.ndarray:
    """Valid packets of each window: ``(n, p)`` int64."""
    L = np.asarray(lengths, np.int64)
    base = np.maximum(L // p, 1)
    lo = np.minimum(np.arange(p)[None, :] * base[:, None], L[:, None])
    hi = np.minimum((np.arange(p)[None, :] + 1) * base[:, None], L[:, None])
    hi[:, -1] = L
    return hi - lo


def max_window(min_len: int, max_len: int, p: int) -> int:
    """The widest window any flow of ``min_len..max_len`` packets has."""
    return max(hi - lo for L in range(min_len, max_len + 1)
               for lo, hi in window_bounds(L, p))


def window_packets(packets: np.ndarray, lengths: np.ndarray, p: int,
                   W: int) -> np.ndarray:
    """``(n, p, W, N_FIELDS)`` f32 windows of padded flows."""
    n = packets.shape[0]
    L = np.asarray(lengths, np.int64)
    width = window_lengths(L, p)
    base = np.maximum(L // p, 1)
    if width.max() > W:
        raise ValueError(f"a window of {width.max()} packets exceeds W={W}")
    out = np.zeros((n, p, W, N_FIELDS), np.float32)
    j = np.arange(W)[None, :]
    rows = np.arange(n)[:, None]
    for w in range(p):
        lo = np.minimum(w * base, L)[:, None]
        src = np.minimum(lo + j, packets.shape[1] - 1)
        win = packets[rows, src]                            # (n, W, F)
        win[j >= width[:, w:w + 1]] = 0.0
        win[:, 0, IAT] = 0.0
        out[:, w] = win
    return out


def bf16(x) -> np.ndarray:
    """Round f32 values to the nearest bfloat16 (ties to even), kept in
    f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


class _Block:
    """The masks and field values of a block of windows, each made once."""

    def __init__(self, win: np.ndarray, rnd):
        self.win, self.rnd = win, rnd
        self.masks, self.vals = {}, {}

    def mask(self, pred: int) -> np.ndarray:
        m = self.masks.get(pred)
        if m is None:
            win = self.win
            m = win[..., VALID] > 0
            if pred == P_FWD:
                m &= win[..., DIR] == 0
            elif pred == P_BWD:
                m &= win[..., DIR] == 1
            elif pred != P_TRUE:
                m &= (win[..., FLAGS].astype(np.int32)
                      & _PRED_FLAG[pred]) > 0
            self.masks[pred] = m
        return m

    def val(self, field: int) -> np.ndarray:
        v = self.vals.get(field)
        if v is None:
            v = self.vals[field] = self.rnd(self.win[..., field])
        return v


def _chain(x: np.ndarray, rnd) -> np.ndarray:
    """Strict left-to-right sum over the last axis, from x[..., 0]."""
    acc = x[..., 0]
    for w in range(1, x.shape[-1]):
        acc = rnd(acc + x[..., w])
    return acc


def _feature(b: _Block, fid: int) -> np.ndarray:
    """Feature ``fid`` of the block's windows: ``(...)`` f32."""
    _, op, field, pred = FEATURES[fid]
    rnd = b.rnd
    mask = b.mask(pred)
    val = b.val(field)
    if op == COUNT:
        return _chain(mask.astype(np.float32), rnd)
    if op == SUM:
        return _chain(rnd(val * mask.astype(np.float32)), rnd)
    if op == SUMSQ:
        return _chain(rnd(rnd(val * val) * mask.astype(np.float32)), rnd)
    if op == MAX:
        m = np.where(mask, val, -np.inf).max(axis=-1)
        return f32(np.where(np.isfinite(m), m, 0.0))
    if op == MIN:
        m = np.where(mask, val, np.inf).min(axis=-1)
        return f32(np.where(np.isfinite(m), m, rnd(F32_MAX)))
    W = mask.shape[-1]
    if op == FIRST:
        i = mask.argmax(axis=-1)
    else:                                               # LAST
        i = W - 1 - mask[..., ::-1].argmax(axis=-1)
    got = np.take_along_axis(val, i[..., None], axis=-1)[..., 0]
    return f32(np.where(mask.any(axis=-1), got, 0.0))


def all_features(windows: np.ndarray, rnd=f32, fids=None,
                 block: int = 16384) -> np.ndarray:
    """``(n, p, N_FEATURES)`` f32 features of ``(n, p, W, N_FIELDS)``
    windows, in blocks of ``block`` flows; with ``fids`` only those
    features (the rest 0)."""
    n, p = windows.shape[:2]
    fids = range(N_FEATURES) if fids is None else fids
    out = np.zeros((n, p, N_FEATURES), np.float32)
    for lo in range(0, n, block):
        b = _Block(windows[lo:lo + block], rnd)
        for fid in fids:
            out[lo:lo + block, :, fid] = _feature(b, int(fid))
    return out
