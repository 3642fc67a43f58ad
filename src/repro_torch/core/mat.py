"""Flow-state store: the switch's register-indexing layer (paper §3.1;
a copy of ``repro.core.mat``).

Models how a Tofino-class pipeline locates per-flow state: the packet's
5-tuple is CRC32-hashed into a fixed register array of M slots.  SpliDT
keeps exactly (SID + counter + dependency chain + k feature registers)
per slot, so M is the concurrent-flow capacity the resource model trades
against k and bits.

This layer provides the scaling evidence the paper claims ("millions of
flows"): slot collisions vs. load factor, eviction behaviour, and the
recirculation-event time series that prices the in-band control channel.
The dense engine (`core/inference.py`) consumes flow-major blocks that
this store admits/evicts -- out-of-order packet arrival is handled here,
keeping the device hot path gather-free.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


def crc32_hash(five_tuples: np.ndarray) -> np.ndarray:
    """CRC32 over packed 5-tuples (n, 5) uint32 -> uint32 hash."""
    ft = np.ascontiguousarray(five_tuples.astype(np.uint32))
    out = np.empty(ft.shape[0], dtype=np.uint32)
    for i in range(ft.shape[0]):
        out[i] = zlib.crc32(ft[i].tobytes()) & 0xFFFFFFFF
    return out


def random_five_tuples(n: int, rng: np.random.Generator) -> np.ndarray:
    """Synthetic (src_ip, dst_ip, src_port, dst_port, proto) tuples."""
    return np.stack([
        rng.integers(0, 2 ** 32, n, dtype=np.uint32),
        rng.integers(0, 2 ** 32, n, dtype=np.uint32),
        rng.integers(1024, 65536, n).astype(np.uint32),
        rng.integers(1, 1024, n).astype(np.uint32),
        rng.choice(np.asarray([6, 17], dtype=np.uint32), n),
    ], axis=1)


@dataclasses.dataclass
class StoreStats:
    n_flows: int
    capacity: int
    load_factor: float
    collisions: int             # flows hashed onto an occupied live slot
    collision_rate: float
    evictions: int


class FlowStore:
    """Hash-indexed slot table with SpliDT's per-flow register layout."""

    def __init__(self, capacity: int, k: int, seed: int = 0):
        self.capacity = int(capacity)
        self.k = int(k)
        self.slot_owner = np.full(self.capacity, -1, dtype=np.int64)
        self.sid = np.zeros(self.capacity, dtype=np.int32)
        self.pkt_count = np.zeros(self.capacity, dtype=np.int32)
        self.regs = np.zeros((self.capacity, k), dtype=np.float32)
        self.collisions = 0
        self.evictions = 0
        self._rng = np.random.default_rng(seed)

    def admit(self, flow_ids: np.ndarray, hashes: np.ndarray) -> np.ndarray:
        """Admit flows; returns slot index per flow (-1 if collided).

        A live collision mirrors switch behaviour: the new flow shares
        (and corrupts) the victim's registers; we count it and refuse the
        slot so accuracy accounting stays honest.
        """
        slots = (hashes % np.uint32(self.capacity)).astype(np.int64)
        out = np.full(flow_ids.shape[0], -1, dtype=np.int64)
        for i, (fid, s) in enumerate(zip(flow_ids, slots)):
            if self.slot_owner[s] == -1:
                self.slot_owner[s] = fid
                self.sid[s] = 0
                self.pkt_count[s] = 0
                self.regs[s] = 0.0
                out[i] = s
            elif self.slot_owner[s] == fid:
                out[i] = s
            else:
                self.collisions += 1
        return out

    def evict(self, slots: np.ndarray):
        live = slots[slots >= 0]
        self.slot_owner[live] = -1
        self.evictions += int(live.size)

    def stats(self) -> StoreStats:
        live = int((self.slot_owner >= 0).sum())
        return StoreStats(
            n_flows=live, capacity=self.capacity,
            load_factor=live / self.capacity,
            collisions=self.collisions,
            collision_rate=self.collisions / max(self.collisions + live, 1),
            evictions=self.evictions,
        )


def collision_curve(capacity: int, loads: list[float], seed: int = 0
                    ) -> list[tuple[float, float]]:
    """Collision rate vs. load factor for CRC-indexed admission."""
    rng = np.random.default_rng(seed)
    out = []
    for lf in loads:
        n = int(capacity * lf)
        store = FlowStore(capacity, k=4, seed=seed)
        ft = random_five_tuples(n, rng)
        h = crc32_hash(ft)
        store.admit(np.arange(n), h)
        out.append((lf, store.stats().collision_rate))
    return out
