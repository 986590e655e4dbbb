"""Serving substrate: continuous-batching engine + cache planning +
Legion accelerator backend (per-step GEMM graphs through a
``repro_torch.legion.Machine`` session, with the engine-view overlapped
latency of each decode batch's merged Program).

The port's legacy mode: whole-prompt prefill and batched decode.
In-flight batching, paged KV and live admission wait for a later slice.
"""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import CacheBudget, kv_bytes_per_token
from repro_torch.serve.legion_backend import (
    LegionServeBackend,
    ProjectionOp,
    RequestTally,
    StageTally,
    StepTally,
    extract_projection_ops,
)

__all__ = [
    "CacheBudget",
    "LegionServeBackend",
    "ProjectionOp",
    "Request",
    "RequestTally",
    "ServeEngine",
    "StageTally",
    "StepTally",
    "extract_projection_ops",
    "kv_bytes_per_token",
]
