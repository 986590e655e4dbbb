"""Cycle-timeline tracing — the Instrument event stream as a visual trace.

:class:`TimelineTracer` rides the pinned :class:`~repro_torch.legion.machine
.Instrument` event order (``on_program_begin`` -> per stage:
``on_stage_begin`` -> ``on_plan_begin`` -> per pass ``on_weight_fetch`` ->
``on_act_stream`` -> ``on_psum`` -> ``on_pass`` (or ``on_window_skip``) ->
``on_assignment_end`` -> ``on_plan_end`` -> ``on_stage_end`` ->
``on_program_end``) and turns it into a structured per-stage, per-Legion,
per-round timeline with cycle-model timestamps:

* **serial placement** — stages in execution order, rounds back-to-back,
  each round as one slice per Legion lane; a round advances time by its
  critical (slowest-Legion) path, so per-stage span lengths equal
  ``CycleCounter.stage_cycles()`` and the total span equals
  ``total_cycles`` *exactly* (the tracer feeds the very same
  ``on_assignment_end`` stream into an internal counter);
* **overlapped placement** — the same rounds shifted by
  :func:`repro_torch.legion.program.compute_pipeline`'s global schedule
  (round-robin tiers within each dependency level, fill+pipeline hidden
  under the previous independent round's stream+drain, fill alone
  prefetched across dependent boundaries whose stationary operand
  already exists), so the makespan equals
  ``PipelineReport.overlapped_cycles`` exactly and the overlap is
  *visible* as rounds sliding left.

``to_chrome()`` exports both placements as Chrome trace-event JSON
(``chrome://tracing`` / https://ui.perfetto.dev): one process per
placement, one thread lane per Legion plus a stage lane, ZTB skips as
instant events.  Timestamps are emitted in **cycles** (1 trace
microsecond == 1 model cycle — the viewer's unit label, not wall time).

Byte counts in slice args are raw per-pass bytes (pre NoC-dedup — the
:class:`~repro_torch.legion.trace.TrafficTracer` owns deduplicated totals).

Both parity guarantees hold for ANY program shape the scheduler accepts
— including the in-flight serve path's *mixed-phase* steps
(:meth:`~repro_torch.serve.legion_backend.LegionServeBackend
.step_program_mixed`: prefill-chunk subgraphs merged with a batched
decode graph), whose serial/overlapped makespans the tracer reproduces
exactly like pure decode batches (pinned by
``tests/test_obs.py::test_mixed_step_program_trace_parity``).

Register the tracer as a session instrument so the per-stage fresh
counters (and hence the pipeline schedule) still run::

    tracer = TimelineTracer(cfg)
    machine = Machine(cfg, backend=PipelinedExecutor(),
                      instruments=[tracer])
    machine.run(program, validate=False)
    tracer.export("trace.json")
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.analytical import (
    boundary_overlap_cycles,
    weight_prefetch_overlap_cycles,
)
from repro_torch.core.config import AcceleratorConfig
from repro_torch.legion.latency import CycleBreakdown, CycleCounter, validate_mem_bw

# A thread id for the per-stage summary lane, below the Legion lanes.
STAGE_LANE = 0
SERIAL_PID = 0
OVERLAPPED_PID = 1


class TimelineError(RuntimeError):
    """The instrument event stream violated the pinned order."""


@dataclasses.dataclass
class SkipEvent:
    """One ZTB fully-sparse window skipped outright."""

    stage: str
    round_: int
    legion: int
    instance: int
    k_tile: int
    n_lo: int
    n_hi: int


@dataclasses.dataclass
class TimelineCell:
    """Accumulated work of one (stage, round, legion) timeline cell."""

    stage: str
    round_: int
    legion: int
    passes: int = 0
    skips: int = 0
    weight_bytes: float = 0.0
    act_bytes: float = 0.0
    psum_bytes: float = 0.0
    # Paged-KV fetches landing on this cell (zero for contiguous runs).
    page_fetches: int = 0
    page_bytes: float = 0.0
    page_waste_bytes: float = 0.0


@dataclasses.dataclass
class ProgramTimeline:
    """One program's structured timeline (cells + cycle placements)."""

    index: int
    program: object
    counter: CycleCounter
    stage_order: List[str] = dataclasses.field(default_factory=list)
    stage_deps: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    cells: Dict[Tuple[str, int, int], TimelineCell] = dataclasses.field(
        default_factory=dict)
    skip_events: List[SkipEvent] = dataclasses.field(default_factory=list)
    complete: bool = False

    # ------------------------------------------------------------------ #
    def round_cells(self) -> Dict[Tuple[str, int], Dict[int, CycleBreakdown]]:
        return self.counter.round_cells()

    def stage_cycles(self) -> Dict[str, int]:
        return self.counter.stage_cycles()

    @property
    def total_cycles(self) -> int:
        return self.counter.total_cycles

    # ------------------------------------------------------------------ #
    def serial_schedule(self) -> "Schedule":
        """Rounds back-to-back: stage order, then round order; a round
        occupies its critical (slowest-Legion) path."""
        cells = self.round_cells()
        slices: List[RoundSlice] = []
        stage_spans: Dict[str, Tuple[int, int]] = {}
        cursor = 0
        for stage in self.stage_order:
            rounds = sorted(r for (s, r) in cells if s == stage)
            start = cursor
            for r in rounds:
                legions = cells[(stage, r)]
                crit = max(b.total for b in legions.values())
                for legion in sorted(legions):
                    slices.append(RoundSlice(
                        stage=stage, round_=r, legion=legion, start=cursor,
                        breakdown=legions[legion],
                        cell=self.cells.get((stage, r, legion)),
                    ))
                cursor += crit
            stage_spans[stage] = (start, cursor)
        return Schedule(slices=slices, stage_spans=stage_spans,
                        makespan=cursor)

    def overlapped_schedule(self) -> "Schedule":
        """The same rounds placed by ``compute_pipeline``'s schedule.

        Mirrors :func:`repro_torch.legion.program.compute_pipeline` operation
        for operation — level iteration, round-robin tier interleave,
        ancestry-gated :func:`boundary_overlap_cycles` hiding plus the
        cross-level :func:`weight_prefetch_overlap_cycles` fill hiding at
        dependent boundaries whose stationary operand already exists — so
        the resulting makespan equals ``PipelineReport.overlapped_cycles``
        exactly (the invariant the telemetry tests pin).
        """
        program = self.program
        cells = self.round_cells()
        rc = self.counter.round_criticals()
        # round order within a stage, to map schedule tiers back to cells
        stage_rounds = {
            stage: sorted(r for (s, r) in cells if s == stage)
            for stage in {s for (s, _r) in cells}
        }
        ancestors = program.ancestors()
        w_blockers = program.stationary_blockers()
        slices: List[RoundSlice] = []
        stage_spans: Dict[str, Tuple[int, int]] = {}
        cursor = 0
        prev: Optional[Tuple[str, CycleBreakdown]] = None
        for level in program.levels():
            names = tuple(s.name for s in level)
            seqs = [rc.get(n, []) for n in names]
            order: List[Tuple[str, int, CycleBreakdown]] = []
            for tier in range(max((len(s) for s in seqs), default=0)):
                for name, seq in zip(names, seqs):
                    if tier < len(seq):
                        order.append((name, tier, seq[tier]))
            for name, tier, nb in order:
                hidden = 0
                if prev is not None:
                    pname, pb = prev
                    if pname != name:
                        if pname not in ancestors.get(name, ()):
                            hidden = boundary_overlap_cycles(
                                pb.stream, nb.fill, nb.pipeline,
                                prev_drain=pb.drain,
                            )
                        elif pname not in w_blockers.get(name, ()):
                            hidden = weight_prefetch_overlap_cycles(
                                pb.stream, nb.fill, prev_drain=pb.drain,
                            )
                start = cursor - hidden
                rnd = stage_rounds[name][tier]
                legions = cells[(name, rnd)]
                for legion in sorted(legions):
                    slices.append(RoundSlice(
                        stage=name, round_=rnd, legion=legion, start=start,
                        breakdown=legions[legion],
                        cell=self.cells.get((name, rnd, legion)),
                    ))
                lo, hi = stage_spans.get(name, (start, start))
                stage_spans[name] = (min(lo, start),
                                     max(hi, start + nb.total))
                cursor = start + nb.total
                prev = (name, nb)
        return Schedule(slices=slices, stage_spans=stage_spans,
                        makespan=cursor)


@dataclasses.dataclass
class RoundSlice:
    """One Legion's work in one round, placed on the cycle axis."""

    stage: str
    round_: int
    legion: int
    start: int
    breakdown: CycleBreakdown
    cell: Optional[TimelineCell] = None

    @property
    def duration(self) -> int:
        return self.breakdown.total

    @property
    def end(self) -> int:
        return self.start + self.duration


@dataclasses.dataclass
class Schedule:
    """A full placement of one program's rounds on the cycle axis."""

    slices: List[RoundSlice]
    stage_spans: Dict[str, Tuple[int, int]]
    makespan: int


class TimelineTracer:
    """Instrument that builds per-program cycle timelines (see module doc).

    ``cfg`` (and ``mem_bw_bytes_per_cycle``) must match the ``Machine``
    the tracer registers on — the tracer derives cycle durations with its
    own internal :class:`CycleCounter` per program, fed from the same
    ``on_assignment_end`` stream, which is what guarantees the exact
    slice-sum == counter-total invariant.  ``Machine.add_instrument``
    enforces this: a tracer constructed bare (``TimelineTracer()``)
    inherits the machine's ``cfg``/``mem_bw`` at registration, and one
    constructed with an explicit config must match the machine's or
    registration raises.

    The tracer also *checks* the pinned event order as it consumes the
    stream: a pass must be preceded by exactly fetch -> stream -> psum, a
    skip or an assignment end must not leave pending pass events, and
    every event must land inside an open program.  Violations raise
    :class:`TimelineError` — the conformance half of the telemetry tests.
    """

    def __init__(self, cfg: Optional[AcceleratorConfig] = None, *,
                 mem_bw_bytes_per_cycle: float = math.inf) -> None:
        self.cfg = cfg
        self.mem_bw = validate_mem_bw(mem_bw_bytes_per_cycle)
        self.programs: List[ProgramTimeline] = []
        self._current: Optional[ProgramTimeline] = None
        # events of the in-flight pass since the last on_pass/on_window_skip
        self._pending: List[str] = []
        self._pending_bytes = {"w": 0.0, "a": 0.0, "p": 0.0}

    # ---- stream state helpers ---------------------------------------- #
    def _open(self, event: str) -> ProgramTimeline:
        if self._current is None:
            raise TimelineError(
                f"{event} outside a program (no on_program_begin seen)"
            )
        return self._current

    def _require_clean(self, event: str) -> None:
        if self._pending:
            raise TimelineError(
                f"{event} with a half-built pass pending "
                f"(saw {self._pending}, expected on_pass first)"
            )

    def _cell(self, stage: str, round_: int, legion: int) -> TimelineCell:
        prog = self._open("pass event")
        key = (stage, round_, legion)
        cell = prog.cells.get(key)
        if cell is None:
            cell = TimelineCell(stage=stage, round_=round_, legion=legion)
            prog.cells[key] = cell
        return cell

    # ---- Instrument protocol ------------------------------------------ #
    def on_program_begin(self, program) -> None:
        if self._current is not None and not self._current.complete:
            raise TimelineError("nested on_program_begin")
        if self.cfg is None:
            raise TimelineError(
                "TimelineTracer has no config: construct it with one or "
                "register it on a Machine (Machine.add_instrument injects "
                "the machine's cfg/mem_bw)"
            )
        self._current = ProgramTimeline(
            index=len(self.programs), program=program,
            counter=CycleCounter(self.cfg,
                                 mem_bw_bytes_per_cycle=self.mem_bw),
        )
        self.programs.append(self._current)

    def on_stage_begin(self, *, stage: str, index: int,
                       deps: Tuple[str, ...]) -> None:
        prog = self._open("on_stage_begin")
        self._require_clean("on_stage_begin")
        if len(prog.stage_order) != index:
            raise TimelineError(
                f"stage {stage!r} arrived with index {index}, expected "
                f"{len(prog.stage_order)} (topological order broken)"
            )
        prog.stage_order.append(stage)
        prog.stage_deps[stage] = tuple(deps)

    def on_page_fetch(self, key, nbytes: float, waste: float, *,
                      stage: str, round_: int, legion: int) -> None:
        """Paged-KV fetch — fired at assignment start (clean pass state),
        before the assignment's first weight fetch."""
        del key
        self._open("on_page_fetch")
        self._require_clean("on_page_fetch")
        cell = self._cell(stage, round_, legion)
        cell.page_fetches += 1
        cell.page_bytes += nbytes
        cell.page_waste_bytes += waste

    def on_weight_fetch(self, key, nbytes: float) -> None:
        self._open("on_weight_fetch")
        if self._pending:
            raise TimelineError(
                f"on_weight_fetch after {self._pending} (pass not closed)"
            )
        self._pending.append("w")
        self._pending_bytes["w"] = nbytes

    def on_act_stream(self, key, nbytes: float) -> None:
        self._open("on_act_stream")
        if self._pending != ["w"]:
            raise TimelineError(
                f"on_act_stream after {self._pending}, expected a weight "
                f"fetch first"
            )
        self._pending.append("a")
        self._pending_bytes["a"] = nbytes

    def on_psum(self, nbytes: float) -> None:
        self._open("on_psum")
        if self._pending != ["w", "a"]:
            raise TimelineError(
                f"on_psum after {self._pending}, expected fetch + stream"
            )
        self._pending.append("p")
        self._pending_bytes["p"] = nbytes

    def on_pass(self, *, stage: str, round_: int, legion: int, instance: int,
                k_tile: int, n_lo: int, n_hi: int) -> None:
        del instance, k_tile, n_lo, n_hi
        self._open("on_pass")
        if self._pending != ["w", "a", "p"]:
            raise TimelineError(
                f"on_pass after {self._pending}, expected fetch -> stream "
                f"-> psum"
            )
        cell = self._cell(stage, round_, legion)
        cell.passes += 1
        cell.weight_bytes += self._pending_bytes["w"]
        cell.act_bytes += self._pending_bytes["a"]
        cell.psum_bytes += self._pending_bytes["p"]
        self._pending.clear()

    def on_window_skip(self, *, stage: str, round_: int, legion: int,
                       instance: int, k_tile: int, n_lo: int,
                       n_hi: int) -> None:
        prog = self._open("on_window_skip")
        self._require_clean("on_window_skip")
        cell = self._cell(stage, round_, legion)
        cell.skips += 1
        prog.skip_events.append(SkipEvent(
            stage=stage, round_=round_, legion=legion, instance=instance,
            k_tile=k_tile, n_lo=n_lo, n_hi=n_hi,
        ))

    def on_assignment_end(self, *, stage: str, round_: int, legion: int,
                          instance: int, m: int, passes: int, skipped: int,
                          weight_bytes: float) -> None:
        prog = self._open("on_assignment_end")
        self._require_clean("on_assignment_end")
        prog.counter.on_assignment_end(
            stage=stage, round_=round_, legion=legion, instance=instance,
            m=m, passes=passes, skipped=skipped, weight_bytes=weight_bytes,
        )
        # zero-pass (fully skipped) assignments still cost a drain: make
        # sure their cell exists so the slice shows up on the lane
        self._cell(stage, round_, legion)

    def on_program_end(self, outputs) -> None:
        del outputs
        prog = self._open("on_program_end")
        self._require_clean("on_program_end")
        prog.complete = True
        self._current = None

    # ---- aggregate accessors ------------------------------------------ #
    def _program(self, index: int = -1) -> ProgramTimeline:
        if not self.programs:
            raise ValueError("TimelineTracer saw no program yet")
        return self.programs[index]

    def stage_cycles(self, index: Optional[int] = None) -> Dict[str, int]:
        """Per-stage serial cycles — of one program, or (default) summed
        across every traced program (note: *summed* per program, unlike a
        single session-lifetime counter whose same-(stage, round) cells
        would merge across programs before taking the Legion max)."""
        if index is not None:
            return self._program(index).stage_cycles()
        out: Dict[str, int] = {}
        for prog in self.programs:
            for stage, cyc in prog.stage_cycles().items():
                out[stage] = out.get(stage, 0) + cyc
        return out

    def total_cycles(self, index: Optional[int] = None) -> int:
        return sum(self.stage_cycles(index).values())

    def serial_cycles(self, index: int = -1) -> int:
        """One program's serial makespan (== its counter's total)."""
        return self._program(index).serial_schedule().makespan

    def overlapped_cycles(self, index: int = -1) -> int:
        """One program's overlapped makespan (== the PipelineReport's
        ``overlapped_cycles`` for the same run)."""
        return self._program(index).overlapped_schedule().makespan

    def executed_passes(self) -> int:
        return sum(p.counter.executed_passes for p in self.programs)

    def skipped_passes(self) -> int:
        return sum(p.counter.skipped_passes for p in self.programs)

    # ---- Chrome trace-event export ------------------------------------ #
    def to_chrome(self) -> dict:
        """Both placements of every traced program as a Chrome trace dict.

        ``pid 0`` is the serial schedule, ``pid 1`` the overlapped one;
        ``tid 0`` is the stage-summary lane, ``tid 1 + legion`` the Legion
        lanes.  Programs place sequentially per pid.  Open the written
        file in ``chrome://tracing`` or https://ui.perfetto.dev.
        """
        events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": SERIAL_PID,
             "args": {"name": "serial schedule (cycles)"}},
            {"name": "process_name", "ph": "M", "pid": OVERLAPPED_PID,
             "args": {"name": "overlapped schedule (cycles)"}},
        ]
        legions = sorted({
            s.legion for prog in self.programs
            for s in prog.serial_schedule().slices
        })
        for pid in (SERIAL_PID, OVERLAPPED_PID):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": STAGE_LANE, "args": {"name": "stages"}})
            for legion in legions:
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": 1 + legion,
                    "args": {"name": f"legion {legion}"},
                })

        offsets = {SERIAL_PID: 0, OVERLAPPED_PID: 0}
        for prog in self.programs:
            placements = [(SERIAL_PID, prog.serial_schedule()),
                          (OVERLAPPED_PID, prog.overlapped_schedule())]
            round_starts: Dict[Tuple[int, str, int, int], int] = {}
            for pid, sched in placements:
                base = offsets[pid]
                for stage in prog.stage_order:
                    lo, hi = sched.stage_spans.get(stage, (0, 0))
                    events.append({
                        "name": stage, "cat": "stage", "ph": "X",
                        "ts": base + lo, "dur": hi - lo,
                        "pid": pid, "tid": STAGE_LANE,
                        "args": {"program": prog.index,
                                 "deps": list(prog.stage_deps.get(stage,
                                                                  ()))},
                    })
                for sl in sched.slices:
                    args = {
                        "program": prog.index, "round": sl.round_,
                        "cycles": sl.breakdown.as_dict(),
                    }
                    if sl.cell is not None:
                        args.update(
                            passes=sl.cell.passes, ztb_skips=sl.cell.skips,
                            weight_bytes=sl.cell.weight_bytes,
                            act_bytes=sl.cell.act_bytes,
                            psum_bytes=sl.cell.psum_bytes,
                        )
                        if sl.cell.page_fetches:
                            args.update(
                                page_fetches=sl.cell.page_fetches,
                                page_bytes=sl.cell.page_bytes,
                                page_waste_bytes=sl.cell.page_waste_bytes,
                            )
                    events.append({
                        "name": f"{sl.stage} r{sl.round_}",
                        "cat": "round", "ph": "X", "ts": base + sl.start,
                        "dur": sl.duration, "pid": pid, "tid": 1 + sl.legion,
                        "args": args,
                    })
                    round_starts[(pid, sl.stage, sl.round_, sl.legion)] = \
                        base + sl.start
                for skip in prog.skip_events:
                    ts = round_starts.get(
                        (pid, skip.stage, skip.round_, skip.legion), base)
                    events.append({
                        "name": "ztb_skip", "cat": "ztb", "ph": "i",
                        "s": "t", "ts": ts, "pid": pid,
                        "tid": 1 + skip.legion,
                        "args": {"program": prog.index, "stage": skip.stage,
                                 "k_tile": skip.k_tile, "n_lo": skip.n_lo,
                                 "n_hi": skip.n_hi,
                                 "instance": skip.instance},
                    })
                offsets[pid] += sched.makespan
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "accelerator": self.cfg.name,
                "time_unit": "1 trace us == 1 model cycle",
            },
        }

    def export(self, path) -> dict:
        """Write :meth:`to_chrome` to ``path``; returns the trace dict."""
        doc = self.to_chrome()
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        return doc
