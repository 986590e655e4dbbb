"""Observability subsystem — timelines, rooflines, metrics, load gen,
and the train step's wall-clock spans.

Four layers riding the runtime's pinned Instrument event stream and the
serve path's cycle model:

- timeline: `TimelineTracer` — per-stage/per-Legion/per-round cycle
            timelines (serial + overlapped placements) exported as Chrome
            trace-event JSON for Perfetto
- roofline: `RooflineTracer` — per-(stage, mode) arithmetic intensity,
            machine balance, attained vs peak OPs/cycle, and the exposed
            weight-prefetch `stall_frac` under finite fetch bandwidth
- metrics:  `MetricsRegistry` — labeled Counter/Gauge/Histogram series
            with deterministic snapshots; `Machine`, `ServeEngine`,
            `LegionServeBackend` accept it via their `metrics=` kwarg
- loadgen:  Poisson/bursty/lognormal arrival traces replayed through a
            live `ServeEngine` on a virtual cycle clock — p50/p99 TTFT,
            per-token latency, occupancy, rejected/deferred admissions,
            and SLO-graded goodput (`run_load(slo=SLO(...))`)

and one on the card's wall clock:

- spans:    `span` / `layer_span` / `backward_span` — `torch.profiler`
            ranges of the train step (forward, backward on the autograd
            thread, remat recomputation, fake-quant, AdamW), recorded only
            while a profiler records

Submodules import lazily (PEP 562): `repro_torch.obs.metrics` stays importable
from `repro_torch.serve.engine` without pulling `loadgen`'s serve-side
dependencies back in.
"""
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.obs.loadgen import (
        SLO,
        Arrival,
        LoadReport,
        RequestRecord,
        bursty_trace,
        lognormal_trace,
        poisson_trace,
        run_load,
    )
    from repro_torch.obs.metrics import (
        Counter,
        Gauge,
        Histogram,
        MetricsRegistry,
    )
    from repro_torch.obs.roofline import (
        RooflineError,
        RooflinePoint,
        RooflineTracer,
    )
    from repro_torch.obs.timeline import (
        ProgramTimeline,
        RoundSlice,
        Schedule,
        SkipEvent,
        TimelineCell,
        TimelineError,
        TimelineTracer,
    )
    from repro_torch.obs.spans import backward_span, layer_span, span

_EXPORTS = {
    "Arrival": "repro_torch.obs.loadgen",
    "LoadReport": "repro_torch.obs.loadgen",
    "RequestRecord": "repro_torch.obs.loadgen",
    "SLO": "repro_torch.obs.loadgen",
    "bursty_trace": "repro_torch.obs.loadgen",
    "lognormal_trace": "repro_torch.obs.loadgen",
    "poisson_trace": "repro_torch.obs.loadgen",
    "run_load": "repro_torch.obs.loadgen",
    "Counter": "repro_torch.obs.metrics",
    "Gauge": "repro_torch.obs.metrics",
    "Histogram": "repro_torch.obs.metrics",
    "MetricsRegistry": "repro_torch.obs.metrics",
    "RooflineError": "repro_torch.obs.roofline",
    "RooflinePoint": "repro_torch.obs.roofline",
    "RooflineTracer": "repro_torch.obs.roofline",
    "ProgramTimeline": "repro_torch.obs.timeline",
    "RoundSlice": "repro_torch.obs.timeline",
    "Schedule": "repro_torch.obs.timeline",
    "SkipEvent": "repro_torch.obs.timeline",
    "TimelineCell": "repro_torch.obs.timeline",
    "TimelineError": "repro_torch.obs.timeline",
    "TimelineTracer": "repro_torch.obs.timeline",
    "backward_span": "repro_torch.obs.spans",
    "layer_span": "repro_torch.obs.spans",
    "span": "repro_torch.obs.spans",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
