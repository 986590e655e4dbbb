"""Serving substrate: continuous-batching engine + cache planning +
Legion accelerator backend (per-step GEMM graphs through a
``repro_torch.legion.Machine`` session, with the engine-view overlapped
latency of each decode batch's merged Program).

In-flight batching (``ServeEngine(prefill_chunk_tokens=...)``) chunks
prefill into fixed token-budget slices and merges them with the batched
decode slots into ONE Program per engine step; ``LiveAdmission`` gates
request intake on the measured ``cache_budget()`` and overlapped token
rate.

Paged KV serving (``ServeEngine(paged_kv=PagedKVCache(...))``) replaces
the per-slot contiguous reservation with a fixed pool of
``page_tokens``-token pages: prompts pin whole pages at admission,
decode extends page by page, and pool exhaustion preempts the
latest-admitted slot (pages freed, request re-queued for re-prefill) —
with page fetches and last-page padding priced by the Legion layer
(``LegionServeBackend(page_tokens=...)``).
"""
from repro_torch.serve.admission import AdmissionStats, LiveAdmission
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import CacheBudget, kv_bytes_per_token
from repro_torch.serve.paged_kv import (
    PageAllocator,
    PagedKVCache,
    PageError,
    PageStats,
)
from repro_torch.serve.legion_backend import (
    LegionServeBackend,
    ProjectionOp,
    RequestTally,
    StageTally,
    StepTally,
    extract_projection_ops,
)

__all__ = [
    "AdmissionStats",
    "CacheBudget",
    "LegionServeBackend",
    "LiveAdmission",
    "PageAllocator",
    "PageError",
    "PageStats",
    "PagedKVCache",
    "ProjectionOp",
    "Request",
    "RequestTally",
    "ServeEngine",
    "StageTally",
    "StepTally",
    "extract_projection_ops",
    "kv_bytes_per_token",
]
