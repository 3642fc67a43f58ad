"""Serving surface (port of ``repro.serve``): live per-packet inference
behind a resident flow table, and LM continuous batching
(``ContinuousBatcher``, RWKV6).  Batch streaming (``run_streaming``,
``stream_batches``) is not ported yet (ROADMAP A.7).
"""
from repro_torch.core.inference import Engine, EngineOptions, EngineResult
from repro_torch.serve.batching import ContinuousBatcher, EngineStats, Request
from repro_torch.serve.flowtable import (
    FlowTable,
    FlowTableServer,
    ServerStats,
    StreamVerdict,
    StreamVerdicts,
)

__all__ = [
    "ContinuousBatcher",
    "Engine",
    "EngineOptions",
    "EngineResult",
    "EngineStats",
    "FlowTable",
    "FlowTableServer",
    "Request",
    "ServerStats",
    "StreamVerdict",
    "StreamVerdicts",
]
