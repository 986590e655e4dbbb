"""Metrics registry — labeled Counter/Gauge/Histogram series with snapshots.

The serve path measures plenty (``LegionServeBackend.summary()``,
``ServeEngine.decode_batch_sizes``, ``CacheBudget``), but every number is
an ad-hoc dict key computed at the end of a run.  This module gives the
runtime a first-class metrics surface in the Prometheus style — named
metrics, optional label dimensions, deterministic ``snapshot()`` dicts —
so TTFT, per-token cycles, slot occupancy, batch sizes, pipeline speedup,
and cache-budget utilization are recorded *as they happen* and can be
diffed across runs.

Wiring is duck-typed: ``Machine``, ``ServeEngine``, ``LegionServeBackend``
and ``repro_torch.obs.loadgen.run_load`` all accept ``metrics=`` (any object
with ``counter``/``gauge``/``histogram`` get-or-create methods) and never
import this module, so the registry stays dependency-free in both
directions.  Histograms keep their raw observations (these are
cycle-model runs, not production telemetry), so ``p50``/``p90``/``p99``
in snapshots are exact percentiles, with bucket counts alongside for
fleet-style aggregation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# Geometric default buckets spanning ratios (~1) through cycle counts
# (~1e9); histograms mostly report exact percentiles from raw samples, the
# buckets exist for fleet-style merging of snapshots.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-1, 10) for m in (1.0, 2.5, 5.0)
) + (float("inf"),)


def _percentile(samples: List[float], q: float) -> float:
    """Exact linear-interpolation percentile (numpy's default method),
    without importing numpy for a handful of values."""
    if not samples:
        raise ValueError("percentile of an empty series")
    xs = sorted(samples)
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(xs):
        return float(xs[-1])
    return float(xs[lo] + (xs[lo + 1] - xs[lo]) * frac)


class _Metric:
    """Shared label-series plumbing for the three metric kinds."""

    kind = "abstract"

    def __init__(self, name: str, *, help: str = "",
                 labels: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labels)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}; "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _label_str(self, key: Tuple[str, ...]) -> str:
        return ",".join(f"{n}={v}" for n, v in zip(self.labelnames, key))

    def _render(self, key: Tuple[str, ...]):
        raise NotImplementedError

    def snapshot_series(self) -> Dict[str, object]:
        return {self._label_str(k): self._render(k)
                for k in sorted(self._series)}


class Counter(_Metric):
    """Monotonically increasing count (events, cycles, bytes)."""

    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc {value})"
            )
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0)

    def _render(self, key):
        return self._series[key]


class Gauge(_Metric):
    """Point-in-time value (occupancy, utilization, current speedup)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = value

    def value(self, **labels) -> float:
        key = self._key(labels)
        if key not in self._series:
            raise KeyError(f"gauge {self.name!r} series {key} never set")
        return self._series[key]

    def _render(self, key):
        return self._series[key]


class Histogram(_Metric):
    """Distribution of observations (TTFT, batch sizes, per-token cycles).

    Raw observations are retained, so :meth:`percentile` and the snapshot
    ``p50``/``p90``/``p99`` are exact, not bucket-interpolated.
    """

    kind = "histogram"

    def __init__(self, name: str, *, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help=help, labels=labels)
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != float("inf"):
            bs.append(float("inf"))
        self.buckets: Tuple[float, ...] = tuple(bs)

    def observe(self, value: float, **labels) -> None:
        self._series.setdefault(self._key(labels), []).append(float(value))

    def observations(self, **labels) -> List[float]:
        return list(self._series.get(self._key(labels), []))

    def count(self, **labels) -> int:
        return len(self._series.get(self._key(labels), []))

    def percentile(self, q: float, **labels) -> float:
        return _percentile(self._series.get(self._key(labels), []), q)

    def _render(self, key):
        xs: List[float] = self._series[key]
        counts = {}
        for le in self.buckets:
            counts[str(le)] = sum(1 for v in xs if v <= le)
        return {
            "count": len(xs),
            "sum": sum(xs),
            "min": min(xs),
            "max": max(xs),
            "mean": sum(xs) / len(xs),
            "p50": _percentile(xs, 50),
            "p90": _percentile(xs, 90),
            "p99": _percentile(xs, 99),
            "buckets": counts,
        }


class MetricsRegistry:
    """Get-or-create home for named metrics, with deterministic snapshots.

        reg = MetricsRegistry()
        reg.counter("serve_decode_steps").inc()
        reg.histogram("load_ttft_cycles").observe(ttft)
        reg.counter("machine_stage_runs", labels=("stage",)).inc(stage="qkv")
        snap = reg.snapshot()     # sorted names, sorted label series

    Re-requesting a name returns the existing metric; re-requesting with a
    different kind or label set raises (one name, one meaning).
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    # ------------------------------------------------------------------ #
    def _get(self, cls, name: str, help: str, labels: Sequence[str],
             **kwargs) -> _Metric:
        existing = self._metrics.get(name)
        if existing is None:
            metric = cls(name, help=help, labels=labels, **kwargs)
            self._metrics[name] = metric
            return metric
        if not isinstance(existing, cls):
            raise ValueError(
                f"metric {name!r} already registered as {existing.kind}, "
                f"requested {cls.kind}"
            )
        if tuple(labels) != existing.labelnames:
            raise ValueError(
                f"metric {name!r} registered with labels "
                f"{existing.labelnames}, requested {tuple(labels)}"
            )
        return existing

    def counter(self, name: str, *, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, *, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, *, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # ------------------------------------------------------------------ #
    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> Dict[str, dict]:
        """Every metric's series as one nested dict, deterministically
        ordered (sorted metric names, sorted label series) — two registries
        fed the same events serialize byte-identically."""
        out: Dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = {
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.labelnames),
                "series": m.snapshot_series(),
            }
        return out
