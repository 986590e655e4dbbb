"""Roofline instrument — per-stage arithmetic intensity from live events.

:class:`RooflineTracer` is a :class:`~repro_torch.legion.machine.Instrument`
that consumes the pinned event stream (weight/act/psum/page traffic,
executed passes, assignment cycle accounting) and reduces each program
stage to one point on the config's roofline:

* **arithmetic intensity** — useful GEMM ops per stationary byte fetched
  (multicast-deduplicated, page-padding included).  The runtime's
  ``mem_bw_bytes_per_cycle`` meters exactly the weight-fetch path — the
  double-buffered prefetch of ``repro_torch.legion.latency`` — so the roofline
  is drawn against stationary traffic; activation and psum bytes are
  reported for context but never cross the metered edge;
* **machine balance** — ``peak_ops_per_cycle(R) / (mem_bw * legions)``:
  the intensity at which compute and fetch time break even.
  ``mem_bw_bytes_per_cycle`` is *per-Legion* fetch bandwidth (the paper
  budgets 128 GB/s per Legion), so a stage engaging L Legions drains L
  fetch pipes in parallel.  Mode-dependent too: ADiP's replication R
  lifts the compute roof for sub-8-bit stationaries, moving the ridge
  right;
* **attained vs peak OPs/cycle** and **bytes/cycle** — useful work (and
  bytes) against the counted critical path, so ``stall_frac`` (the
  exposed weight-prefetch share of the stage's cycles) explains exactly
  the gap a finite ``mem_bw_bytes_per_cycle`` opens.

Like :class:`~repro_torch.obs.timeline.TimelineTracer`, the tracer either takes
``cfg``/``mem_bw_bytes_per_cycle`` at construction or inherits both from
the :class:`~repro_torch.legion.machine.Machine` it registers on (which raises
on a mismatch rather than mis-modeling silently).  Mode labels come from
the resolved :class:`~repro_torch.legion.modes.ModeSpec` (``W1.58``/``W4``/
``W8``, ``+ZTB`` when sparse), so a mixed-precision program yields one
row per (stage, mode) out of a single run.

The whole-workload bandwidth axis (sweeps, the stall knee) lives in
``repro_torch.legion.roofline``; this module owns the per-stage view.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, List, Optional

from repro_torch.core.config import AcceleratorConfig
from repro_torch.legion.latency import CycleBreakdown, CycleCounter, \
    validate_mem_bw
from repro_torch.legion.trace import TrafficTracer


class RooflineError(ValueError):
    """A roofline tracer was driven outside its contract."""


@dataclasses.dataclass
class RooflinePoint:
    """One stage's position on the roofline (one executed layer)."""

    stage: str
    mode: str                 # W1.58 / W4 / W8, "+ZTB" when sparse
    weight_bits: int
    r: int                    # ADiP replication factor of the mode
    ops: int                  # useful GEMM ops (2 * count * M * K * N)
    peak_ops_per_cycle: int   # compute roof at this mode's R
    mem_bw_bytes_per_cycle: float   # per-Legion fetch bandwidth
    legions_used: int = 1     # parallel fetch pipes the plan engages
    weight_bytes: float = 0.0  # deduplicated stationary traffic (+page waste)
    act_bytes: float = 0.0     # context only: streamed, not metered
    psum_bytes: float = 0.0    # context only: on-chip accumulator traffic
    breakdown: CycleBreakdown = dataclasses.field(
        default_factory=CycleBreakdown)

    # ---- derived ------------------------------------------------------ #
    @property
    def cycles(self) -> int:
        """Critical-path (slowest-Legion-per-round) cycles of the stage."""
        return self.breakdown.total

    @property
    def arithmetic_intensity(self) -> float:
        """Useful ops per stationary byte over the metered fetch edge."""
        return self.ops / self.weight_bytes if self.weight_bytes else 0.0

    @property
    def fetch_bytes_per_cycle(self) -> float:
        """Aggregate metered bandwidth: per-Legion ``mem_bw`` times the
        parallel fetch pipes the stage's plan engages."""
        return self.mem_bw_bytes_per_cycle * self.legions_used

    @property
    def machine_balance(self) -> float:
        """Break-even intensity (ops/byte); 0 at infinite bandwidth —
        every workload is compute-bound when fetches are free."""
        if self.mem_bw_bytes_per_cycle == math.inf:
            return 0.0
        return self.peak_ops_per_cycle / self.fetch_bytes_per_cycle

    @property
    def memory_bound(self) -> bool:
        return self.arithmetic_intensity < self.machine_balance

    @property
    def roofline_ops_per_cycle(self) -> float:
        """The roof over this stage: min(compute peak, BW * intensity)."""
        return min(float(self.peak_ops_per_cycle),
                   self.arithmetic_intensity * self.fetch_bytes_per_cycle)

    @property
    def attained_ops_per_cycle(self) -> float:
        return self.ops / self.cycles if self.cycles else 0.0

    @property
    def attained_bytes_per_cycle(self) -> float:
        """Stationary bytes over the critical path; approaches the
        aggregate :attr:`fetch_bytes_per_cycle` from below once the stage
        stalls (drain cycles and Legion imbalance keep it under)."""
        return self.weight_bytes / self.cycles if self.cycles else 0.0

    @property
    def efficiency(self) -> float:
        """Attained over the applicable roof (1.0 = on the roofline)."""
        roof = self.roofline_ops_per_cycle
        return self.attained_ops_per_cycle / roof if roof else 0.0

    @property
    def stall_frac(self) -> float:
        """Exposed weight-prefetch share of the stage's cycles."""
        return self.breakdown.stall / self.cycles if self.cycles else 0.0

    def as_dict(self) -> Dict[str, object]:
        return {
            "stage": self.stage,
            "mode": self.mode,
            "weight_bits": self.weight_bits,
            "r": self.r,
            "legions_used": self.legions_used,
            "ops": self.ops,
            "cycles": self.cycles,
            "weight_bytes": self.weight_bytes,
            "act_bytes": self.act_bytes,
            "psum_bytes": self.psum_bytes,
            "arithmetic_intensity": self.arithmetic_intensity,
            "machine_balance": self.machine_balance,
            "memory_bound": self.memory_bound,
            "peak_ops_per_cycle": self.peak_ops_per_cycle,
            "roofline_ops_per_cycle": self.roofline_ops_per_cycle,
            "attained_ops_per_cycle": self.attained_ops_per_cycle,
            "attained_bytes_per_cycle": self.attained_bytes_per_cycle,
            "efficiency": self.efficiency,
            "stall_frac": self.stall_frac,
            "cycle_breakdown": self.breakdown.as_dict(),
        }


@dataclasses.dataclass
class _StageAcc:
    """Raw per-stage accumulation before the counter's critical-path
    reduction (traffic dedups per stage, like the Machine's own per-stage
    tracer)."""

    mode: str
    weight_bits: int
    r: int
    peak: int
    legions: int = 1
    ops: int = 0
    traffic: TrafficTracer = dataclasses.field(default_factory=TrafficTracer)


class RooflineTracer:
    """Reduce a run's event stream to per-(stage, mode) roofline points.

    Register on a :class:`~repro_torch.legion.machine.Machine` (inheriting its
    config and fetch bandwidth) or construct standalone with an explicit
    ``cfg``.  After the run, :meth:`rows` yields one
    :class:`RooflinePoint` per stage in execution order; :meth:`as_dicts`
    is the JSON-ready form benchmarks embed.
    """

    def __init__(self, cfg: Optional[AcceleratorConfig] = None, *,
                 mem_bw_bytes_per_cycle: float = math.inf) -> None:
        self.cfg = cfg
        self.mem_bw = validate_mem_bw(mem_bw_bytes_per_cycle)
        self._stages: Dict[str, _StageAcc] = {}
        self._order: List[str] = []
        self._current: Optional[str] = None
        self._counter: Optional[CycleCounter] = None

    # ---- Instrument protocol ------------------------------------------ #
    def on_program_begin(self, program) -> None:
        del program
        if self.cfg is None:
            raise RooflineError(
                "RooflineTracer has no AcceleratorConfig — construct it "
                "with one or register it on a Machine")
        if self._counter is None:
            self._counter = CycleCounter(
                self.cfg, mem_bw_bytes_per_cycle=self.mem_bw)

    def on_plan_begin(self, plan, mode, ctx) -> None:
        stage = plan.stage
        acc = self._stages.get(stage)
        if acc is None:
            acc = _StageAcc(mode=mode.name, weight_bits=mode.weight_bits,
                            r=mode.r,
                            peak=self.cfg.peak_ops_per_cycle(mode.r),
                            legions=plan.legions_used())
            self._stages[stage] = acc
            self._order.append(stage)
        acc.ops += 2 * ctx.count * ctx.m * ctx.k * ctx.n
        self._current = stage

    def _acc(self) -> _StageAcc:
        if self._current is None:
            raise RooflineError("traffic event outside a plan scope")
        return self._stages[self._current]

    def on_weight_fetch(self, key: Hashable, nbytes: float) -> None:
        self._acc().traffic.weight_tile(key, nbytes)

    def on_act_stream(self, key: Hashable, nbytes: float) -> None:
        self._acc().traffic.act_stream(key, nbytes)

    def on_psum(self, nbytes: float) -> None:
        self._acc().traffic.psum(nbytes)

    def on_page_fetch(self, key: Hashable, nbytes: float, waste: float,
                      *, stage: str, round_: int, legion: int) -> None:
        del stage, round_, legion
        self._acc().traffic.page_fetch(key, nbytes, waste)

    def on_assignment_end(self, *, stage: str, round_: int, legion: int,
                          instance: int, m: int, passes: int, skipped: int,
                          weight_bytes: float) -> None:
        del instance
        assert self._counter is not None
        self._counter.record_assignment(
            stage=stage, round_=round_, legion=legion, m=m, passes=passes,
            skipped=skipped, weight_bytes=weight_bytes,
        )

    # ---- results ------------------------------------------------------ #
    def rows(self) -> List[RooflinePoint]:
        """One roofline point per traced stage, in execution order."""
        if self._counter is None:
            return []
        breakdowns = self._counter.stage_breakdown()
        out: List[RooflinePoint] = []
        for stage in self._order:
            acc = self._stages[stage]
            out.append(RooflinePoint(
                stage=stage, mode=acc.mode, weight_bits=acc.weight_bits,
                r=acc.r, ops=acc.ops, peak_ops_per_cycle=acc.peak,
                mem_bw_bytes_per_cycle=self.mem_bw,
                legions_used=acc.legions,
                weight_bytes=acc.traffic.totals.weight_bytes,
                act_bytes=acc.traffic.totals.act_bytes,
                psum_bytes=acc.traffic.totals.psum_bytes,
                breakdown=breakdowns.get(stage, CycleBreakdown()),
            ))
        return out

    def by_mode(self) -> Dict[str, List[RooflinePoint]]:
        """Rows grouped by mode label (W1.58/W4/W8, +ZTB variants)."""
        out: Dict[str, List[RooflinePoint]] = {}
        for p in self.rows():
            out.setdefault(p.mode, []).append(p)
        return out

    def as_dicts(self) -> List[Dict[str, object]]:
        return [p.as_dict() for p in self.rows()]
