"""Bandwidth sweeps — locating the stall knee of the finite-HBM model.

``simulate()`` and the counted runtime agree exactly on the exposed
weight-prefetch stall (``repro_torch.legion.latency``), so the question "at what
memory bandwidth does this workload leave the compute-bound plateau?" has a
closed answer.  This module asks it systematically:

* :func:`hbm_bytes_per_cycle` converts the paper's HBM budget (SS V-B's
  128 GB/s per Legion out of 16 x 512 GB/s stacks, the same figures behind
  ``repro_torch.core.analytical.hbm_legions_supported``) into the runtime's
  ``mem_bw_bytes_per_cycle`` unit for a config;
* :func:`find_stall_knee` bisects the analytic model for the smallest
  bandwidth at which no stall is exposed — the roofline ridge of the
  workload set;
* :func:`sweep_bandwidth` evaluates a list of bandwidth points, optionally
  executing each one through a :class:`~repro_torch.legion.machine.Machine`
  (``cross_validate=True``) so the counted stall cross-checks the analytic
  one at 0% error, and exports the sweep as plain JSON or a Chrome
  trace-event counter track.

The per-stage roofline view (arithmetic intensity, attained vs peak
OPs/cycle) lives in the JAX package's ``obs.roofline``, not ported yet;
this module owns the whole-workload bandwidth axis.  The port's one
addition: :func:`sweep_bandwidth` takes the ``device`` its Machines run
on.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.simulator import simulate
from repro_torch.core.sparsity import ZTBStats
from repro_torch.core.workloads import GEMMWorkload
from repro_torch.device import DeviceLike
from repro_torch.legion.latency import validate_mem_bw
from repro_torch.legion.trace import relative_error

# Paper SS V-B: one 512 GB/s HBM stack feeds four Legions, i.e. 128 GB/s
# of dedicated fetch bandwidth per Legion.
PAPER_LEGION_BW_GBS = 128.0


def hbm_bytes_per_cycle(
    cfg: AcceleratorConfig, *, legion_bw_gbs: float = PAPER_LEGION_BW_GBS,
) -> float:
    """The paper's HBM budget for ``cfg`` in ``mem_bw_bytes_per_cycle``.

    Bandwidth scales linearly with Legion count (each Legion owns a slice
    of the stack budget), then divides by the clock to land in the unit
    every finite-bandwidth consumer takes.
    """
    return cfg.units * legion_bw_gbs * 1e9 / cfg.freq_hz


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One bandwidth point of a sweep (analytic, optionally measured)."""

    mem_bw_bytes_per_cycle: float
    cycles: int                       # analytic total incl. stall
    stall_cycles: int                 # analytic exposed-prefetch share
    measured_cycles: Optional[int] = None    # counted (cross_validate=True)
    measured_stall_cycles: Optional[int] = None

    @property
    def stall_frac(self) -> float:
        return self.stall_cycles / self.cycles if self.cycles else 0.0

    @property
    def stalled(self) -> bool:
        return self.stall_cycles > 0

    @property
    def rel_err(self) -> Optional[float]:
        """Counted-vs-analytic cycle error; None without a measured run."""
        if self.measured_cycles is None:
            return None
        return relative_error(self.measured_cycles, self.cycles)

    def as_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "mem_bw_bytes_per_cycle": self.mem_bw_bytes_per_cycle,
            "cycles": self.cycles,
            "stall_cycles": self.stall_cycles,
            "stall_frac": self.stall_frac,
        }
        if self.measured_cycles is not None:
            out["measured_cycles"] = self.measured_cycles
            out["measured_stall_cycles"] = self.measured_stall_cycles
            out["rel_err"] = self.rel_err
        return out


@dataclasses.dataclass
class BandwidthSweep:
    """A workload set's cycles-vs-bandwidth curve plus its knee."""

    arch: str
    label: str
    base_cycles: int          # compute-bound plateau (infinite bandwidth)
    knee_bw: float            # smallest bandwidth with zero exposed stall
    points: List[SweepPoint]  # ascending bandwidth

    @property
    def knee_cycles(self) -> int:
        """Cycles at (and above) the knee — the plateau the curve joins."""
        return self.base_cycles

    @property
    def worst_rel_err(self) -> float:
        """Largest counted-vs-analytic error over the measured points."""
        errs = [p.rel_err for p in self.points if p.rel_err is not None]
        return max(errs) if errs else 0.0

    def stalled_points(self) -> List[SweepPoint]:
        return [p for p in self.points if p.stalled]

    def as_dict(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "label": self.label,
            "base_cycles": self.base_cycles,
            "knee_bw_bytes_per_cycle": self.knee_bw,
            "knee_cycles": self.knee_cycles,
            "worst_rel_err": self.worst_rel_err,
            "points": [p.as_dict() for p in self.points],
        }

    # ---- exports ------------------------------------------------------ #
    def to_chrome(self) -> dict:
        """The sweep as a Chrome trace-event counter track.

        Each bandwidth point becomes one tick of two counter series
        (``cycles`` split into stalled/compute, and ``stall_frac``), so
        the knee reads directly off the counter graph in
        https://ui.perfetto.dev — the same viewer the timeline tracer
        targets.  Trace time is the point index (bandwidth is in the
        args), ascending bandwidth left to right.
        """
        events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": f"bandwidth sweep: {self.label}"}},
        ]
        for i, p in enumerate(self.points):
            args = {"bw_bytes_per_cycle": p.mem_bw_bytes_per_cycle}
            events.append({
                "name": "cycles", "ph": "C", "ts": i, "pid": 0,
                "args": {"compute": p.cycles - p.stall_cycles,
                         "stall": p.stall_cycles, **args},
            })
            events.append({
                "name": "stall_frac", "ph": "C", "ts": i, "pid": 0,
                "args": {"stall_frac": p.stall_frac, **args},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "accelerator": self.arch,
                "knee_bw_bytes_per_cycle": self.knee_bw,
                "time_unit": "1 trace us == 1 sweep point "
                             "(ascending bandwidth)",
            },
        }

    def export(self, path) -> dict:
        """Write :meth:`to_chrome` to ``path``; returns the trace dict."""
        doc = self.to_chrome()
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        return doc

    def export_json(self, path) -> Dict[str, object]:
        """Write :meth:`as_dict` to ``path``; returns the dict."""
        doc = self.as_dict()
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        return doc


def _totals(cfg: AcceleratorConfig, workloads: Sequence[GEMMWorkload],
            ztb: Optional[ZTBStats], bw: float) -> tuple:
    rep = simulate(cfg, workloads, ztb=ztb, mem_bw_bytes_per_cycle=bw)
    cycles = sum(s.cycles for s in rep.stages.values())
    stall = sum(s.stall_cycles for s in rep.stages.values())
    return cycles, stall


def find_stall_knee(
    cfg: AcceleratorConfig,
    workloads: Sequence[GEMMWorkload],
    *,
    ztb: Optional[ZTBStats] = None,
    hi: Optional[float] = None,
    iters: int = 64,
) -> float:
    """Smallest ``mem_bw_bytes_per_cycle`` exposing zero stall (analytic).

    Bisects the monotone stall curve: above the returned bandwidth the
    workload set is compute-bound (prefetch fully hidden), below it at
    least one stage exposes fetch cycles.  ``hi`` seeds the upper bracket
    (defaults to the paper HBM budget, doubled until stall-free).
    """
    workloads = list(workloads)
    lo = 0.0                      # exclusive: bw must be > 0
    hi = hi or hbm_bytes_per_cycle(cfg)
    while _totals(cfg, workloads, ztb, hi)[1] > 0:
        lo = hi
        hi *= 2.0
    for _ in range(iters):
        mid = (lo + hi) / 2.0
        if mid in (lo, hi):       # float resolution exhausted
            break
        if _totals(cfg, workloads, ztb, mid)[1] > 0:
            lo = mid
        else:
            hi = mid
    return hi


def sweep_bandwidth(
    cfg: AcceleratorConfig,
    workloads: Sequence[GEMMWorkload],
    bandwidths: Optional[Sequence[float]] = None,
    *,
    ztb: Optional[ZTBStats] = None,
    ztb_sparsity: float = 0.0,
    cross_validate: bool = False,
    seed: int = 0,
    label: Optional[str] = None,
    device: DeviceLike = None,
) -> BandwidthSweep:
    """Evaluate a workload set across memory-bandwidth points.

    Without ``bandwidths`` the sweep brackets the paper HBM budget
    (:func:`hbm_bytes_per_cycle`) with 1/8x..2x geometric points, which
    straddles the knee for every paper workload.  With
    ``cross_validate=True`` every point also executes through a
    finite-bandwidth :class:`~repro_torch.legion.machine.Machine`, counting
    cycles pass by pass; the counted and analytic stall must agree at 0%
    error (:attr:`BandwidthSweep.worst_rel_err`) — the falsifiability
    gate the roofline benchmark asserts.  ``ztb_sparsity`` prunes the
    quantized stages' weights; the measured run derives the ZTB stats
    from the pruned data and the analytic side reuses them, keeping both
    sides on the same skipped-window count.  ``device`` is where those
    Machines run (default: the CUDA card).
    """
    workloads = list(workloads)
    if bandwidths is None:
        budget = hbm_bytes_per_cycle(cfg)
        bandwidths = [budget * f for f in
                      (0.125, 0.25, 0.5, 1.0, 2.0)]
    bandwidths = sorted(validate_mem_bw(bw) for bw in bandwidths)

    from repro_torch.legion.machine import Machine

    if cross_validate and ztb_sparsity > 0 and ztb is None:
        # One dense probe run recovers the ZTB stats the measured points
        # will see (same seed => same pruned data), so the analytic-only
        # numbers (base cycles, knee) skip the same windows.
        probe = Machine(cfg, device=device)
        for w in workloads:
            if w.weight_bits < 8:
                rep = probe.run(w, seed=seed, ztb_sparsity=ztb_sparsity,
                                check_outputs=False, validate=False)
                ztb = rep.ztb_stats
                break

    base_cycles, _ = _totals(cfg, workloads, ztb, math.inf)
    knee = find_stall_knee(cfg, workloads, ztb=ztb,
                           hi=max(bandwidths))

    points: List[SweepPoint] = []
    for bw in bandwidths:
        cycles, stall = _totals(cfg, workloads, ztb, bw)
        measured = measured_stall = None
        if cross_validate:
            machine = Machine(cfg, mem_bw_bytes_per_cycle=bw, device=device)
            _tv, cycle_vals = machine.cross_validate(
                workloads, rtol=0.0, seed=seed, ztb_sparsity=ztb_sparsity,
                check_outputs=False,
            )
            measured = sum(v.measured for v in cycle_vals)
            measured_stall = sum(v.measured_breakdown["stall"]
                                 for v in cycle_vals)
            # the machine's own analytic side saw the same ZTB stats —
            # fold it in so rel_err is counted-vs-analytic, not
            # counted-vs-a-different-ztb-model
            cycles = sum(v.analytic for v in cycle_vals)
            stall = sum(v.analytic_breakdown["stall"] for v in cycle_vals)
        points.append(SweepPoint(
            mem_bw_bytes_per_cycle=bw, cycles=cycles, stall_cycles=stall,
            measured_cycles=measured, measured_stall_cycles=measured_stall,
        ))

    return BandwidthSweep(
        arch=cfg.name,
        label=label or "+".join(sorted({w.stage for w in workloads})),
        base_cycles=base_cycles, knee_bw=knee, points=points,
    )
