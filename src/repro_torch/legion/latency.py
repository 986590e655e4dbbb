"""Cycle model for the Legion runtime — counting the latency eq. (2) derives.

``simulate()`` *derives* stage latency from closed-form tile counts
(``unit_latency_cycles``, paper eq. 2).  This module *counts* it: while a
:class:`~repro_torch.legion.machine.Machine` runs a StagePlan, it reports every
assignment's executed (K-window, N-tile) passes to a :class:`CycleCounter`,
which spends cycles the way the ADiP-based Legion hardware would
(arXiv:2510.10623's fill/drain/prefetch timing model):

* **systolic fill** — each tile pass pays one ``D``-deep fill before results
  stream out (the ``+1`` in ``D * (MT + 1)``; WS sync-FIFOs pay ``2D``);
* **K-window streaming** — ``MT`` row-tiles of ``D`` cycles each stream the
  activation rows through the array per pass;
* **pipeline** — ``P`` extra stages per pass for ADiP's shared shifters /
  accumulators;
* **drain** — one ``D``-deep output drain per (legion, round) work chunk;
* **weight prefetch** — the next stationary tile is fetched into the double
  buffer *during* the current pass; only the exposed remainder
  ``max(0, fetch_cycles - pass_cycles)`` stalls the array.  With the default
  infinite fetch bandwidth prefetch is fully hidden — exactly eq. (2)'s
  assumption — while a finite ``mem_bw_bytes_per_cycle`` makes the
  bandwidth-bound regime measurable;
* **ZTB** — fully-sparse windows never enter the array: no pass, no cycles
  (the runtime simply does not report them as executed).

Legions within a round run in parallel, so a round costs its slowest
Legion; rounds serialize.  :func:`cross_validate_cycles` compares the summed
count against ``SimReport`` per-stage cycles — the latency half of the
falsifiability story (the traffic half lives in ``repro_torch.legion.trace``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.analytical import pass_cycle_breakdown
from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.workloads import GEMMWorkload
from repro_torch.legion.trace import relative_error


def validate_mem_bw(mem_bw_bytes_per_cycle: float) -> float:
    """Shared fetch-bandwidth validator (single source of the message).

    Every finite-bandwidth consumer (``CycleCounter``, ``Machine``,
    ``TimelineTracer``, ``sweep_bandwidth``) accepts the same parameter
    with the same contract: strictly positive, ``math.inf`` meaning
    prefetch is fully hidden.  Returns the value so callers can assign
    directly."""
    if mem_bw_bytes_per_cycle <= 0:
        raise ValueError(
            "mem_bw_bytes_per_cycle must be > 0 (math.inf = prefetch "
            f"fully hidden); got {mem_bw_bytes_per_cycle}"
        )
    return mem_bw_bytes_per_cycle


@dataclasses.dataclass
class CycleBreakdown:
    """Where one work chunk's cycles go (all integers, sums exactly)."""

    stream: int = 0      # activation rows streaming through the array
    fill: int = 0        # systolic fill per tile pass
    pipeline: int = 0    # ADiP shared shifter/accumulator stages
    drain: int = 0       # output drain per (legion, round) chunk
    stall: int = 0       # exposed weight-prefetch cycles (finite bandwidth)

    @property
    def total(self) -> int:
        return self.stream + self.fill + self.pipeline + self.drain \
            + self.stall

    def add(self, other: "CycleBreakdown") -> None:
        self.stream += other.stream
        self.fill += other.fill
        self.pipeline += other.pipeline
        self.drain += other.drain
        self.stall += other.stall

    def scaled(self, factor: int) -> "CycleBreakdown":
        return CycleBreakdown(
            stream=self.stream * factor, fill=self.fill * factor,
            pipeline=self.pipeline * factor, drain=self.drain * factor,
            stall=self.stall * factor,
        )

    def as_dict(self) -> Dict[str, int]:
        return {"stream": self.stream, "fill": self.fill,
                "pipeline": self.pipeline, "drain": self.drain,
                "stall": self.stall}


class CycleCounter:
    """Accumulates executed-pass cycle counts during a ``Machine`` run.

    The runtime calls :meth:`record_assignment` once per assignment with the
    number of (K-window, N-tile) passes it actually executed (ZTB-skipped
    windows excluded) and the stationary bytes those passes fetched.  The
    counter derives per-pass cycles from the config's dataflow and folds the
    parallel/serial structure: per (stage, round) the *slowest* Legion sets
    the round's latency; rounds (and stages) serialize.

    Implements the :class:`~repro_torch.legion.machine.Instrument` protocol via
    :meth:`on_assignment_end`, so a counter registers directly on a
    ``Machine`` (``Machine.run`` attaches a fresh one per run by default).
    """

    def __init__(self, cfg: AcceleratorConfig, *,
                 mem_bw_bytes_per_cycle: float = math.inf) -> None:
        self.cfg = cfg
        self.mem_bw = validate_mem_bw(mem_bw_bytes_per_cycle)
        # (stage, round) -> legion -> accumulated breakdown
        self._cells: Dict[Tuple[str, int], Dict[int, CycleBreakdown]] = {}
        self.executed_passes = 0
        self.skipped_passes = 0       # ZTB fully-sparse windows never run

    # ------------------------------------------------------------------ #
    def record_assignment(
        self, *, stage: str, round_: int, legion: int, m: int,
        passes: int, skipped: int = 0, weight_bytes: float = 0.0,
    ) -> None:
        cfg = self.cfg
        mt = max(math.ceil(m / cfg.d), 1)
        per_pass = pass_cycle_breakdown(cfg, mt)
        pass_c = per_pass.stream + per_pass.fill + per_pass.pipeline
        stall = 0
        if passes and self.mem_bw != math.inf:
            # double-buffered prefetch: per pass only the fetch time that
            # exceeds the pass's compute is exposed
            fetch = (weight_bytes / passes) / self.mem_bw
            stall = int(round(passes * max(0.0, fetch - pass_c)))
        br = CycleBreakdown(
            stream=passes * per_pass.stream, fill=passes * per_pass.fill,
            pipeline=passes * per_pass.pipeline, drain=per_pass.drain,
            stall=stall,
        )
        cell = self._cells.setdefault((stage, round_), {})
        if legion in cell:
            cell[legion].add(br)
        else:
            cell[legion] = br
        self.executed_passes += passes
        self.skipped_passes += skipped

    # ---- Instrument protocol (repro_torch.legion.machine) ------------------- #
    def on_assignment_end(self, *, stage: str, round_: int, legion: int,
                          instance: int, m: int, passes: int, skipped: int,
                          weight_bytes: float) -> None:
        del instance  # cycles fold by (stage, round, legion), not instance
        self.record_assignment(
            stage=stage, round_=round_, legion=legion, m=m, passes=passes,
            skipped=skipped, weight_bytes=weight_bytes,
        )

    # ------------------------------------------------------------------ #
    def round_cells(self) -> Dict[Tuple[str, int], Dict[int, CycleBreakdown]]:
        """Copy of the accumulated ``(stage, round) -> legion ->
        breakdown`` cells — the full per-Legion resolution beneath
        :meth:`round_criticals` (which keeps only each round's slowest
        Legion).  ``repro_torch.obs.timeline`` draws one lane per Legion from
        these."""
        return {key: dict(legions) for key, legions in self._cells.items()}

    def round_criticals(self) -> Dict[str, List[CycleBreakdown]]:
        """Per-stage list of each round's critical (slowest-Legion) path,
        in round order.

        The per-round resolution the pipelined program executor schedules
        with (``repro_torch.legion.program.compute_pipeline``): rounds of
        dependency-independent stages interleave, and the breakdown's
        ``stream``/``fill``/``pipeline`` terms decide how much of an
        incoming round hides under the outgoing one.  Summing a stage's
        rounds reproduces :meth:`stage_breakdown` exactly.
        """
        out: Dict[str, List[CycleBreakdown]] = {}
        for (stage, _rnd), legions in sorted(self._cells.items()):
            crit = max(legions.values(), key=lambda b: b.total)
            out.setdefault(stage, []).append(crit)
        return out

    def stage_breakdown(self) -> Dict[str, CycleBreakdown]:
        """Per-stage breakdown of the critical (slowest-Legion) path."""
        out: Dict[str, CycleBreakdown] = {}
        for stage, rounds in self.round_criticals().items():
            agg = out.setdefault(stage, CycleBreakdown())
            for crit in rounds:
                agg.add(crit)
        return out

    def stage_cycles(self) -> Dict[str, int]:
        return {s: b.total for s, b in self.stage_breakdown().items()}

    @property
    def total_cycles(self) -> int:
        return sum(self.stage_cycles().values())


def merge_round_criticals(
    parts: Iterable[Dict[str, List[CycleBreakdown]]],
) -> Dict[str, List[CycleBreakdown]]:
    """Fold several counters' per-stage round criticals into one map.

    The merged-graph composition path: a batch/multi-layer program's
    pipelined schedule (``repro_torch.legion.program.compute_pipeline``) wants
    one ``stage -> rounds`` map spanning every node, but the serve
    backend executes (and caches) the *sub*-programs separately — shared
    projections by row count, each slot's attention pair by (rows,
    context).  Each part contributes its nodes' round lists; a stage
    appearing in several parts concatenates in part order (its rounds
    serialize).  Round criticals depend only on the plan geometry, not on
    which graph the node executed in, so the composed map schedules the
    merged levels exactly as a monolithic execution would.
    """
    out: Dict[str, List[CycleBreakdown]] = {}
    for part in parts:
        for stage, rounds in part.items():
            out.setdefault(stage, []).extend(rounds)
    return out


# --------------------------------------------------------------------------- #
# Cross-validation against the analytic simulator
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class CycleValidation:
    """Measured (counted) vs analytic (eq. 2) cycles for one stage."""

    stage: str
    measured: int
    analytic: int
    rtol: float
    measured_breakdown: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    analytic_breakdown: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def rel_err(self) -> float:
        return relative_error(self.measured, self.analytic)

    @property
    def ok(self) -> bool:
        return self.rel_err <= self.rtol

    def __str__(self) -> str:
        return (f"[{self.stage}] cycles measured={self.measured} vs "
                f"analytic={self.analytic}: {self.rel_err * 100:.2f}% "
                f"({'OK' if self.ok else 'MISMATCH'} @ rtol={self.rtol})")


def cross_validate_cycles(
    cfg: AcceleratorConfig,
    workloads: Iterable[GEMMWorkload],
    *,
    rtol: float = 0.05,
    seed: int = 0,
    ztb_sparsity: float = 0.0,
    check_outputs: bool = True,
    device=None,
) -> List[CycleValidation]:
    """Execute every workload through the legion runtime, counting cycles,
    and compare per-stage totals against ``simulate()``'s latency model.

    One layer of each workload executes numerically; counted cycles are
    scaled by ``w.layers`` to match the simulator's whole-model accounting
    (the same convention as ``trace.cross_validate``).  With
    ``ztb_sparsity > 0`` both sides account the skipped fully-sparse
    windows — the measured side by literally not running them.

    Thin wrapper over :meth:`repro_torch.legion.machine.Machine.cross_validate`
    (which measures traffic and cycles in a single execution pass).
    """
    from repro_torch.legion.machine import Machine

    _traffic_vals, cycle_vals = Machine(cfg, device=device).cross_validate(
        workloads, rtol=rtol, seed=seed, ztb_sparsity=ztb_sparsity,
        check_outputs=check_outputs,
    )
    return cycle_vals


def total_cycle_error(validations: List[CycleValidation]) -> float:
    """Relative error of the summed (whole-model) cycle count."""
    return relative_error(sum(v.measured for v in validations),
                          sum(v.analytic for v in validations))
