"""Stateful feature definitions for SpliDT (a copy of ``repro.core.features``).

A *feature* is a windowed statistic over a flow's packets (CICFlowMeter
style).  Each feature is described by an op-code triple

    (op, field, predicate)

so that the data plane can compute it with a per-SID operator-selection
table (paper Fig. 4): the MAT keyed on the subtree id (SID) selects which
op/field/predicate to apply to each of the k feature register slots.

Packet record layout (dense, one row per packet):

    col 0: timestamp   (float seconds; monotone within a flow)
    col 1: size        (bytes)
    col 2: direction   (0 = fwd, 1 = bwd)
    col 3: flags       (bitmask: SYN=1, ACK=2, FIN=4, RST=8, PSH=16, URG=32)
    col 4: iat         (inter-arrival time, derived via the dependency
                        chain -- requires the previous timestamp register)
    col 5: valid       (1 for a real packet, 0 for padding)

The codes here are the contract between the host tables and the CUDA
feature kernel (``csrc/feature_window.cu`` repeats them as constants).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# --- packet field columns -------------------------------------------------
PKT_TS = 0
PKT_SIZE = 1
PKT_DIR = 2
PKT_FLAGS = 3
PKT_IAT = 4
PKT_VALID = 5
PKT_NFIELDS = 6

# --- flag bits --------------------------------------------------------------
FLAG_SYN = 1
FLAG_ACK = 2
FLAG_FIN = 4
FLAG_RST = 8
FLAG_PSH = 16
FLAG_URG = 32

# --- op codes (register update ops) -----------------------------------------
OP_NONE = 0     # slot unused by the active subtree
OP_COUNT = 1    # regs += pred
OP_SUM = 2      # regs += field * pred
OP_MAX = 3      # regs = max(regs, field) where pred
OP_MIN = 4      # regs = min(regs, field) where pred  (init +inf)
OP_LAST = 5     # regs = field where pred
OP_SUMSQ = 6    # regs += field^2 * pred       (dep depth 1: needs square)
OP_FIRST = 7    # regs = field on first matching packet

N_OPS = 8

# --- predicate codes --------------------------------------------------------
PRED_TRUE = 0
PRED_FWD = 1
PRED_BWD = 2
PRED_SYN = 3
PRED_ACK = 4
PRED_FIN = 5
PRED_RST = 6
PRED_PSH = 7
PRED_URG = 8

N_PREDS = 9

# flag-bit predicates, in the order the reference mask ORs them in
PRED_FLAGS = ((PRED_SYN, FLAG_SYN), (PRED_ACK, FLAG_ACK),
              (PRED_FIN, FLAG_FIN), (PRED_RST, FLAG_RST),
              (PRED_PSH, FLAG_PSH), (PRED_URG, FLAG_URG))


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One stateful feature = one register-update program."""

    fid: int
    name: str
    op: int
    field: int
    pred: int = PRED_TRUE
    dep_depth: int = 0     # extra dependency-chain stages (paper: <= 3)

    @property
    def init_value(self) -> float:
        if self.op == OP_MIN:
            return np.float32(np.finfo(np.float32).max)
        return np.float32(0.0)


def _mk_registry() -> list[FeatureSpec]:
    specs: list[FeatureSpec] = []

    def add(name, op, field, pred=PRED_TRUE, dep=0):
        specs.append(FeatureSpec(len(specs), name, op, field, pred, dep))

    # volume / count features
    add("pkt_count", OP_COUNT, PKT_SIZE)
    add("byte_sum", OP_SUM, PKT_SIZE)
    add("pkt_size_max", OP_MAX, PKT_SIZE)
    add("pkt_size_min", OP_MIN, PKT_SIZE)
    add("pkt_size_sumsq", OP_SUMSQ, PKT_SIZE, dep=1)
    add("pkt_size_first", OP_FIRST, PKT_SIZE)
    add("pkt_size_last", OP_LAST, PKT_SIZE)
    # direction-split volume
    add("fwd_pkt_count", OP_COUNT, PKT_SIZE, PRED_FWD)
    add("bwd_pkt_count", OP_COUNT, PKT_SIZE, PRED_BWD)
    add("fwd_byte_sum", OP_SUM, PKT_SIZE, PRED_FWD)
    add("bwd_byte_sum", OP_SUM, PKT_SIZE, PRED_BWD)
    add("fwd_size_max", OP_MAX, PKT_SIZE, PRED_FWD)
    add("bwd_size_max", OP_MAX, PKT_SIZE, PRED_BWD)
    add("fwd_size_min", OP_MIN, PKT_SIZE, PRED_FWD)
    add("bwd_size_min", OP_MIN, PKT_SIZE, PRED_BWD)
    # inter-arrival time (dependency chain: prev-timestamp register)
    add("iat_sum", OP_SUM, PKT_IAT, dep=1)
    add("iat_max", OP_MAX, PKT_IAT, dep=1)
    add("iat_min", OP_MIN, PKT_IAT, dep=1)
    add("iat_sumsq", OP_SUMSQ, PKT_IAT, dep=2)
    add("fwd_iat_sum", OP_SUM, PKT_IAT, PRED_FWD, dep=1)
    add("bwd_iat_sum", OP_SUM, PKT_IAT, PRED_BWD, dep=1)
    add("fwd_iat_max", OP_MAX, PKT_IAT, PRED_FWD, dep=1)
    add("bwd_iat_max", OP_MAX, PKT_IAT, PRED_BWD, dep=1)
    # flag counters
    add("syn_count", OP_COUNT, PKT_SIZE, PRED_SYN)
    add("ack_count", OP_COUNT, PKT_SIZE, PRED_ACK)
    add("fin_count", OP_COUNT, PKT_SIZE, PRED_FIN)
    add("rst_count", OP_COUNT, PKT_SIZE, PRED_RST)
    add("psh_count", OP_COUNT, PKT_SIZE, PRED_PSH)
    add("urg_count", OP_COUNT, PKT_SIZE, PRED_URG)
    # flag-gated sizes
    add("syn_size_sum", OP_SUM, PKT_SIZE, PRED_SYN)
    add("psh_size_sum", OP_SUM, PKT_SIZE, PRED_PSH)
    add("ack_size_max", OP_MAX, PKT_SIZE, PRED_ACK)
    # timing
    add("ts_first", OP_FIRST, PKT_TS, dep=1)
    add("ts_last", OP_LAST, PKT_TS, dep=1)
    add("syn_iat_sum", OP_SUM, PKT_IAT, PRED_SYN, dep=1)
    add("psh_iat_max", OP_MAX, PKT_IAT, PRED_PSH, dep=1)
    # direction-flag crosses
    add("fwd_psh_count", OP_COUNT, PKT_SIZE, PRED_PSH)
    add("bwd_ack_count", OP_COUNT, PKT_SIZE, PRED_ACK)
    add("fwd_size_sumsq", OP_SUMSQ, PKT_SIZE, PRED_FWD, dep=1)
    add("bwd_size_sumsq", OP_SUMSQ, PKT_SIZE, PRED_BWD, dep=1)
    add("bwd_size_last", OP_LAST, PKT_SIZE, PRED_BWD)
    return specs


REGISTRY: list[FeatureSpec] = _mk_registry()
N_FEATURES = len(REGISTRY)          # 41, matching D1's N in the paper

# packed (N_FEATURES, 4) table: op, field, pred, dep_depth
FEATURE_TABLE = np.asarray(
    [[s.op, s.field, s.pred, s.dep_depth] for s in REGISTRY], dtype=np.int32
)
