"""Recirculation-bandwidth model (paper §3.2.1, Tables 1 & 5; a copy of
``repro.core.recirc``).

Each flow issues one 64-byte control packet per partition transition
(window boundary that does not exit).  Aggregate in-band control traffic
for F concurrent flows is

    bw = F * E[transitions per flow] * pkt_bits / E[flow duration]

under steady-state churn (a flow's transitions are spread over its
lifetime; concurrency F is sustained by arrivals).  Transition counts
come from the model's *measured* inference trace (early exits reduce
them; single-partition models recirculate nothing, reproducing the
0.0 +- 0.0 rows of Table 5).

Environments follow the paper's two datacenter workloads (Roy et al.):
  WS (webserver): long-lived flows -> longer mean duration
  HD (hadoop):    short bursty mice flows -> ~2x the control-packet rate
Durations are calibrated so worst-case bandwidth lands in the paper's
range (<= ~60 Mbps at 1M flows, << 100 Gbps budget).
"""
from __future__ import annotations

import dataclasses

import numpy as np

CONTROL_PKT_BYTES = 64


@dataclasses.dataclass(frozen=True)
class Environment:
    name: str
    mean_flow_duration_s: float


WEBSERVER = Environment("WS", 60.0)
HADOOP = Environment("HD", 30.0)
ENVIRONMENTS = {"WS": WEBSERVER, "HD": HADOOP}


@dataclasses.dataclass
class RecircStats:
    mean_mbps: float
    std_mbps: float
    pkts_per_sec: float
    fraction_of_budget: float   # vs 100 Gbps recirculation path


def recirc_bandwidth(
    transitions_per_flow: np.ndarray,
    flows: int,
    env: Environment,
    *,
    budget_gbps: float = 100.0,
) -> RecircStats:
    """Bandwidth of the in-band control channel.

    ``transitions_per_flow``: measured per-flow transition counts from an
    inference trace (sampled flows; scaled to ``flows`` concurrent).
    """
    t = np.asarray(transitions_per_flow, dtype=np.float64)
    pkt_bits = CONTROL_PKT_BYTES * 8
    rate = flows / env.mean_flow_duration_s          # flow completions/s
    mean_bps = rate * t.mean() * pkt_bits
    std_bps = rate * t.std() * pkt_bits
    return RecircStats(
        mean_mbps=mean_bps / 1e6,
        std_mbps=std_bps / 1e6,
        pkts_per_sec=rate * t.mean(),
        fraction_of_budget=mean_bps / (budget_gbps * 1e9),
    )


def time_to_detection(
    packets: np.ndarray,
    lengths: np.ndarray,
    exit_partition: np.ndarray,
    n_partitions: int,
) -> np.ndarray:
    """Per-flow TTD: time from flow start to the end of the exit window
    (paper Fig. 10).  One-shot baselines detect at flow completion, i.e.
    ``exit_partition == n_partitions - 1`` for every flow."""
    from repro_torch.core.features import PKT_TS
    from repro_torch.flows.windows import window_bounds

    n = lengths.shape[0]
    ttd = np.zeros(n, dtype=np.float64)
    for i in range(n):
        if exit_partition[i] < 0:
            # -1 sentinel: the flow never took an exit action, so it has
            # no detection time — NaN, not the last window's end (Python
            # negative indexing would silently report a plausible TTD)
            ttd[i] = np.nan
            continue
        L = int(lengths[i])
        bounds = window_bounds(L, n_partitions)
        _, hi = bounds[int(exit_partition[i])]
        t_end = packets[i, min(hi, L) - 1, PKT_TS]
        ttd[i] = float(t_end - packets[i, 0, PKT_TS])
    return ttd
