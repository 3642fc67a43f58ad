"""Serving surface (port of ``repro.serve``): batch streaming
(``run_streaming``, ``stream_batches``: micro-batches on CUDA streams),
live per-packet inference behind a resident flow table, and LM continuous
batching (``ContinuousBatcher``, RWKV6).
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
from repro_torch.serve.streaming import (
    microbatches,
    run_streaming,
    stream_batches,
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
    "microbatches",
    "run_streaming",
    "stream_batches",
]
