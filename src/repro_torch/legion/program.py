"""`Program` — multi-stage dependency graphs for the Legion runtime.

The paper's headline latencies come from running *whole attention blocks*
through the Legions — QKV projections, the act-to-act score/output GEMMs
with KV multicast, the output projection — with tiles multicast and rounds
overlapped.  A single :class:`~repro_torch.core.scheduler.StagePlan` cannot
express that: the right unit of execution is the stage *graph* (the same
conclusion TensorRT-LLM's engine graphs and ADiP's pipelined core reach).
This module makes the graph first-class:

* :class:`ProgramStage` — one named node: a
  :class:`~repro_torch.core.workloads.GEMMWorkload` (or an explicit plan),
  operands that are concrete arrays, synthesized, or :class:`Ref`\\ s to
  earlier stages' outputs (optionally transformed — requantization,
  softmax, head concat), and an operand-source tag distinguishing
  stationary *weights* from stationary *activations* (the K/V matrices of
  act-to-act attention);

* :class:`Program` — a validated DAG of stages with topological order and
  dependency levels (antichains), executed by
  :meth:`repro_torch.legion.machine.Machine.run`.  :meth:`Program.merge` folds
  *independent* programs into one batch graph (per-slot decode attention
  interleaved as an antichain — the continuous-batching shape vLLM-style
  schedulers produce);

* :func:`lower_attention` / :func:`lower_serve_step` /
  :func:`lower_serve_batch` — lowering builders producing the paper's
  attention block (QKV -> score -> softmax -> output -> O-proj), a full
  serving step (projections AND attention, KV-cache matrices as per-slot
  stationary operands with position-dependent K/N), and one decode step's
  merged batch graph.  ``explicit_layers`` spans the program over several
  *explicit* transformer layers — layer ``l+1``'s QKV streams layer
  ``l``'s MLP output through a real cross-layer dependency instead of the
  ``layers``-scalar shortcut;

* :func:`compute_pipeline` — the overlapped-round timing model behind
  :class:`~repro_torch.legion.machine.PipelinedExecutor`: rounds of
  dependency-independent stages interleave, and each round boundary whose
  two sides have no dependency path hides the incoming round's systolic
  fill + pipeline ramp under the outgoing round's streaming + drain
  (:func:`repro_torch.core.analytical.boundary_overlap_cycles`) — within a
  level *and* across level boundaries (the outgoing level's last round
  may belong to a stage the incoming stage never consumes, e.g. another
  slot of a merged batch).  A *data-dependent* boundary whose stationary
  operand is independent of the outgoing stage still hides the incoming
  fill as a cross-level weight prefetch — the stationary tiles already
  exist in memory while the streamed input is being produced
  (:func:`repro_torch.core.analytical.weight_prefetch_overlap_cycles`).
  Overlapped cycles are always <= the serial per-stage sum, with exact
  equality when every adjacent round pair is same-stage or
  stationary-blocked (the incoming stationary operand produced by the
  outgoing stage) — the program-level cross-validation invariant;

* :func:`reference_outputs` — a pure-NumPy execution of the whole graph
  (no plans, no kernels, no machine) that program runs are checked
  against end to end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from repro_torch.core.analytical import (
    boundary_overlap_cycles,
    weight_prefetch_overlap_cycles,
)
from repro_torch.core.scheduler import StagePlan
from repro_torch.core.sparsity import ZeroTileBook
from repro_torch.core.workloads import (
    ATTN_OUTPUT,
    ATTN_SCORE,
    K_PROJ,
    OUT_PROJ,
    Q_PROJ,
    QKV_PROJ,
    V_PROJ,
    AttentionSpec,
    GEMMWorkload,
    attention_workloads,
    decode_attention_workloads,
)
from repro_torch.legion.latency import CycleBreakdown
from repro_torch.legion.modes import ModeSpec

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.legion.machine import RunReport

# Stationary-operand sources: the paper's weight-stationary projections
# vs the act-to-act attention stages whose stationary operand is itself
# an activation (K/V — in serving, the KV-cache matrices).
WEIGHT = "weight"
STATIONARY_ACT = "stationary_act"


# --------------------------------------------------------------------------- #
# Operand references + transforms
# --------------------------------------------------------------------------- #

class Ref:
    """An operand sourced from earlier stage outputs, optionally transformed.

    ``Ref("qkv_proj")`` is the producer's raw ``[count, M, N]`` outputs;
    ``Ref("qkv_proj", f)`` applies ``f`` to them (slice heads, requantize,
    transpose K, softmax...).  A multi-producer ref —
    ``Ref(("a", "b"), f)`` — passes every producer's outputs to ``f``
    positionally (e.g. concatenating per-slot attention rows).
    """

    def __init__(
        self,
        stage: Union[str, Sequence[str]],
        transform: Optional[Callable[..., np.ndarray]] = None,
    ) -> None:
        self.producers: Tuple[str, ...] = (
            (stage,) if isinstance(stage, str) else tuple(stage)
        )
        if not self.producers:
            raise ValueError("Ref needs at least one producer stage")
        if len(self.producers) > 1 and transform is None:
            raise ValueError(
                "a multi-producer Ref needs a transform combining the "
                f"outputs; got producers {self.producers}"
            )
        self.transform = transform

    def resolve(self, outputs: Dict[str, np.ndarray]) -> np.ndarray:
        vals = [outputs[p] for p in self.producers]
        if self.transform is None:
            return vals[0]
        return np.asarray(self.transform(*vals))

    def __repr__(self) -> str:
        t = getattr(self.transform, "__name__", None) if self.transform \
            else None
        return f"Ref({', '.join(self.producers)}{f', {t}' if t else ''})"


def requantize_int8(arr: np.ndarray, *, magnitude: int = 127) -> np.ndarray:
    """Symmetric per-tensor requantization to int8.

    The inter-stage link of a program: stage outputs are int32 partial
    sums; the next stage streams int8 activations.  Deterministic, so the
    pure-NumPy :func:`reference_outputs` reproduces runtime results
    bit-for-bit.
    """
    a = np.asarray(arr, np.float64)
    peak = float(np.abs(a).max()) if a.size else 0.0
    if peak == 0.0:
        return np.zeros(a.shape, np.int8)
    return np.clip(np.rint(a / peak * magnitude), -127, 127).astype(np.int8)


def softmax_int8(
    scores: np.ndarray, *, scale: Optional[float] = None,
) -> np.ndarray:
    """Row softmax over the key axis of attention scores, requantized to
    int8 probabilities — the score -> output link of the attention graph.

    ``scale`` maps raw int32 scores into softmax's active range (the
    lowering builders pass ``1 / (qmax * kmax * sqrt(head_dim))``);
    default is ``1/sqrt(num_keys)``.
    """
    s = np.asarray(scores, np.float64)
    if scale is None:
        scale = 1.0 / math.sqrt(max(s.shape[-1], 1))
    z = s * scale
    z = z - z.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p = p / p.sum(axis=-1, keepdims=True)
    return np.rint(p * 127.0).astype(np.int8)


def swiglu_int8(up: np.ndarray) -> np.ndarray:
    """SwiGLU combine of the two mlp_up branches: silu(w1 x) * (w3 x),
    requantized to int8 for the mlp_down stage (gate normalized into
    sigmoid's active range first — raw int32 magnitudes would saturate)."""
    a = np.asarray(up, np.float64)
    gate, value = a[0], a[1]
    peak = float(np.abs(gate).max()) or 1.0
    z = gate / peak * 4.0
    return requantize_int8(z / (1.0 + np.exp(-z)) * value)


# --------------------------------------------------------------------------- #
# Program graph
# --------------------------------------------------------------------------- #

Operand = Union[None, np.ndarray, Ref]


@dataclasses.dataclass
class ProgramStage:
    """One node of a :class:`Program`.

    Exactly one of ``workload`` (lowered to a plan by the machine) or
    ``plan`` must be set.  Operands: ``x`` streams, ``w`` is stationary;
    each is a concrete array, a :class:`Ref` to earlier outputs, or
    ``None`` — a workload stage with both operands ``None`` synthesizes
    them (the legacy single-workload behaviour).  ``w_source`` tags
    whether the stationary operand is a weight matrix or a stationary
    *activation* (K/V).  ``after`` adds control dependencies beyond the
    operand refs.
    """

    name: str
    workload: Optional[GEMMWorkload] = None
    plan: Optional[StagePlan] = None
    x: Operand = None
    w: Operand = None
    w_source: str = WEIGHT
    mode: Optional[ModeSpec] = None
    ztb: Union[None, bool, ZeroTileBook, Sequence[ZeroTileBook]] = None
    ztb_sparsity: float = 0.0
    after: Tuple[str, ...] = ()

    @property
    def deps(self) -> Tuple[str, ...]:
        """Producer stages this node waits on (operand refs + ``after``)."""
        seen: List[str] = []
        for op in (self.x, self.w):
            if isinstance(op, Ref):
                for p in op.producers:
                    if p not in seen:
                        seen.append(p)
        for p in self.after:
            if p not in seen:
                seen.append(p)
        return tuple(seen)

def _rename_ref(op: "Operand", mapping: Dict[str, str]) -> "Operand":
    """A Ref with producers renamed through ``mapping`` (external names —
    not in the mapping — pass through); non-Ref operands unchanged."""
    if not isinstance(op, Ref):
        return op
    return Ref(tuple(mapping.get(p, p) for p in op.producers), op.transform)


def _retagged(stage: "ProgramStage", mapping: Dict[str, str]) \
        -> "ProgramStage":
    """A copy of ``stage`` with its name, refs, and after-edges renamed."""
    return dataclasses.replace(
        stage,
        name=mapping.get(stage.name, stage.name),
        x=_rename_ref(stage.x, mapping),
        w=_rename_ref(stage.w, mapping),
        after=tuple(mapping.get(a, a) for a in stage.after),
    )


class ProgramError(ValueError):
    """A Program's graph is malformed (dup names, bad refs, cycles...)."""


class Program:
    """A validated DAG of :class:`ProgramStage` nodes.

    Execute with ``Machine(cfg).run(program)`` -> :class:`ProgramReport`.
    """

    def __init__(self, stages: Sequence[ProgramStage] = ()) -> None:
        self.stages: List[ProgramStage] = []
        self._by_name: Dict[str, ProgramStage] = {}
        for s in stages:
            self.add(s)

    # ------------------------------------------------------------------ #
    def add(self, stage: ProgramStage) -> ProgramStage:
        if not isinstance(stage, ProgramStage):
            raise TypeError(f"expected ProgramStage, got "
                            f"{type(stage).__name__}")
        if stage.name in self._by_name:
            raise ProgramError(f"duplicate stage name {stage.name!r}")
        if (stage.workload is None) == (stage.plan is None):
            raise ProgramError(
                f"stage {stage.name!r}: set exactly one of workload / plan"
            )
        self.stages.append(stage)
        self._by_name[stage.name] = stage
        return stage

    def __len__(self) -> int:
        return len(self.stages)

    def __iter__(self):
        return iter(self.stages)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __getitem__(self, name: str) -> ProgramStage:
        return self._by_name[name]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Refs resolve, operands are coherent, and the graph is acyclic
        (:meth:`topo_order` raises on cycles)."""
        if not self.stages:
            raise ProgramError("empty program")
        for s in self.stages:
            for dep in s.deps:
                if dep not in self._by_name:
                    raise ProgramError(
                        f"stage {s.name!r} references unknown stage {dep!r}"
                    )
                if dep == s.name:
                    raise ProgramError(f"stage {s.name!r} depends on itself")
            if s.workload is None and (s.x is None or s.w is None):
                raise ProgramError(
                    f"stage {s.name!r}: explicit-plan stages need explicit "
                    f"x and w operands"
                )
            if s.workload is not None and (s.x is None) != (s.w is None):
                raise ProgramError(
                    f"stage {s.name!r}: pass both x and w, or neither "
                    f"(neither = synthesized operands)"
                )
            if s.ztb_sparsity and s.x is not None:
                raise ProgramError(
                    f"stage {s.name!r}: ztb_sparsity prunes *synthesized* "
                    f"operands; with explicit operands prune the weights "
                    f"yourself and pass ztb="
                )
        self.topo_order()

    def topo_order(self) -> List[ProgramStage]:
        """Stages in dependency order (stable: insertion order breaks
        ties).  Raises :class:`ProgramError` on cycles."""
        done: Dict[str, bool] = {}
        order: List[ProgramStage] = []

        def visit(s: ProgramStage, chain: Tuple[str, ...]) -> None:
            state = done.get(s.name)
            if state is True:
                return
            if state is False:
                raise ProgramError(
                    f"dependency cycle: {' -> '.join(chain + (s.name,))}"
                )
            done[s.name] = False
            for dep in s.deps:
                if dep in self._by_name:
                    visit(self._by_name[dep], chain + (s.name,))
            done[s.name] = True
            order.append(s)

        for s in self.stages:
            visit(s, ())
        return order

    def levels(self) -> List[List[ProgramStage]]:
        """Dependency levels (antichains): stages in the same level have no
        path between them and may overlap; levels serialize."""
        depth: Dict[str, int] = {}
        for s in self.topo_order():
            depth[s.name] = 1 + max(
                (depth[d] for d in s.deps if d in depth), default=-1,
            )
        out: List[List[ProgramStage]] = [[] for _ in
                                         range(max(depth.values()) + 1)]
        for s in self.stages:       # insertion order within a level
            out[depth[s.name]].append(s)
        return out

    @property
    def is_chain(self) -> bool:
        """Every level holds exactly one stage — nothing to overlap."""
        return all(len(level) == 1 for level in self.levels())

    def ancestors(self) -> Dict[str, frozenset]:
        """Transitive dependency closure: ``name -> every stage reachable
        through deps``.  The independence test behind the pipelined
        schedule — two stages with no ancestry either way may overlap."""
        anc: Dict[str, frozenset] = {}
        for s in self.topo_order():
            a: set = set()
            for dep in s.deps:
                a.add(dep)
                a |= anc.get(dep, frozenset())
            anc[s.name] = frozenset(a)
        return anc

    def stationary_blockers(self) -> Dict[str, frozenset]:
        """Stages a node's *stationary* operand transitively depends on:
        ``name -> {producer stages of w} ∪ their ancestors`` (empty when
        ``w`` is a concrete array, synthesized, or ``None``).

        The cross-level weight-prefetch test behind the pipelined
        schedule: a round may start fetching its stationary tiles under a
        data-dependent predecessor round as long as that predecessor is
        NOT among the stationary operand's own producers — the weights
        (or an earlier-written K-V cache) already exist in memory even
        though the streamed input does not yet
        (:func:`repro_torch.core.analytical.weight_prefetch_overlap_cycles`).
        """
        anc = self.ancestors()
        out: Dict[str, frozenset] = {}
        for s in self.stages:
            blockers: set = set()
            if isinstance(s.w, Ref):
                for p in s.w.producers:
                    blockers.add(p)
                    blockers |= anc.get(p, frozenset())
            out[s.name] = frozenset(blockers)
        return out

    # ------------------------------------------------------------------ #
    @classmethod
    def merge(
        cls,
        programs: Sequence["Program"],
        *,
        tags: Optional[Sequence[str]] = None,
    ) -> "Program":
        """Merge *independent* programs into one batch graph.

        Every program's stage names gain its ``tags`` entry as a suffix
        (default ``[i]`` when merging more than one program, empty for a
        single one); :class:`Ref`\\ s and ``after`` edges between a
        program's *own* stages are renamed along, while refs to names
        outside it pass through untouched — so lowering builders can
        merge per-slot subgraphs that hang off shared stages (the batched
        projections) added around the merged result.

        The merged graph holds the inputs' stages side by side: their
        dependency levels align, so same-level stages of different slots
        form exactly the antichain a
        :class:`~repro_torch.legion.machine.PipelinedExecutor` interleaves —
        batch-level pipelining of one decode step's per-slot attention
        programs.  The result is NOT validated here (callers with
        external refs validate after adding the surrounding stages);
        colliding names (e.g. duplicate tags) raise :class:`ProgramError`
        at ``add`` time.
        """
        programs = list(programs)
        if tags is None:
            tags = [""] if len(programs) == 1 else \
                [f"[{i}]" for i in range(len(programs))]
        tags = list(tags)
        if len(tags) != len(programs):
            raise ValueError(
                f"{len(tags)} tags for {len(programs)} programs"
            )
        merged = cls()
        for prog, tag in zip(programs, tags):
            mapping = {name: name + tag for name in prog.names}
            for st in prog:
                merged.add(_retagged(st, mapping))
        return merged

    # ------------------------------------------------------------------ #
    @classmethod
    def single(
        cls,
        work: Union[GEMMWorkload, StagePlan],
        x: Optional[np.ndarray] = None,
        w: Optional[np.ndarray] = None,
        *,
        mode: Optional[ModeSpec] = None,
        ztb: Union[None, bool, ZeroTileBook, Sequence[ZeroTileBook]] = None,
        ztb_sparsity: float = 0.0,
    ) -> "Program":
        """One-node program — what the legacy ``Machine.run(workload)`` /
        ``Machine.run(plan, x, w)`` calls become (same validation, same
        error messages)."""
        if isinstance(work, GEMMWorkload):
            if (x is None) != (w is None):
                raise ValueError("pass both x and w, or neither")
            if x is not None and ztb_sparsity:
                raise ValueError(
                    "ztb_sparsity prunes *synthesized* operands; with "
                    "explicit x and w, prune the weights yourself and pass "
                    "ztb=True (or pre-built books)"
                )
            stage = ProgramStage(
                name=work.stage, workload=work, x=x, w=w, mode=mode,
                ztb=ztb, ztb_sparsity=ztb_sparsity,
            )
        elif isinstance(work, StagePlan):
            if ztb_sparsity:
                raise ValueError(
                    "ztb_sparsity synthesizes operands and only applies to "
                    "workload runs; pass ztb= for an explicit plan"
                )
            if x is None or w is None:
                raise ValueError("Machine.run(plan, ...) needs explicit "
                                 "x and w operands")
            stage = ProgramStage(name=work.stage, plan=work, x=x, w=w,
                                 mode=mode, ztb=ztb)
        else:
            raise TypeError(
                f"expected GEMMWorkload, StagePlan, or Program, got "
                f"{type(work).__name__}"
            )
        return cls([stage])


# --------------------------------------------------------------------------- #
# Pure-NumPy reference execution
# --------------------------------------------------------------------------- #

def reference_outputs(program: Program) -> Dict[str, np.ndarray]:
    """Execute the whole graph in plain NumPy — no plans, kernels, or
    machine — and return per-stage ``[count, M, N]`` outputs.

    The end-to-end check for program runs: every operand resolves through
    the same refs/transforms, so a ``Machine.run(program)`` must reproduce
    these outputs exactly (int path) for the threading, instance wiring,
    and per-stage numerics all at once.  Requires concrete operands (no
    synthesis).  ``ztb=True`` stages are allowed: self-derived books gate
    only windows whose weights are entirely zero, so the dense reference
    is still exact (the MoE expert-skip lowering rides this — an unchosen
    expert carries zeroed weights, and both sides produce zeros).
    Caller-passed books may gate nonzero data and have no dense reference.
    """
    program.validate()
    outs: Dict[str, np.ndarray] = {}
    for st in program.topo_order():
        if st.x is None or st.w is None:
            raise ProgramError(
                f"stage {st.name!r}: reference execution needs concrete "
                f"operands (synthesized stages have no reference)"
            )
        if st.ztb not in (None, False, True):
            raise ProgramError(
                f"stage {st.name!r}: reference execution is dense; "
                f"caller-passed ZTB books would gate contributions "
                f"(ztb=True is fine — self-derived books gate only "
                f"all-zero windows)"
            )
        x = st.x.resolve(outs) if isinstance(st.x, Ref) else np.asarray(st.x)
        w = st.w.resolve(outs) if isinstance(st.w, Ref) else np.asarray(st.w)
        count = st.workload.count if st.workload is not None else (
            max(a.instance for a in st.plan.assignments) + 1
        )
        int_path = (np.issubdtype(x.dtype, np.integer)
                    and np.issubdtype(w.dtype, np.integer))
        acc = np.int64 if int_path else np.float64
        res = []
        for i in range(count):
            xi = (x if x.ndim == 2 else x[i]).astype(acc)
            wi = (w if w.ndim == 2 else w[i]).astype(acc)
            res.append(xi @ wi)
        outs[st.name] = np.stack(res).astype(
            np.int32 if int_path else np.float32
        )
    return outs


# --------------------------------------------------------------------------- #
# Pipelined timing model
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class LevelTiming:
    """One dependency level's serial vs overlapped cycles."""

    stages: Tuple[str, ...]
    serial_cycles: int
    overlapped_cycles: int

    @property
    def hidden_cycles(self) -> int:
        return self.serial_cycles - self.overlapped_cycles


@dataclasses.dataclass
class PipelineReport:
    """The pipelined executor's overlapped schedule vs the serial sum.

    Invariants (the program-level cross-validation): ``overlapped_cycles
    <= serial_cycles`` always, with equality exactly when every adjacent
    round pair is same-stage or *stationary-blocked* (the incoming
    round's stationary operand is produced by the outgoing stage —
    attention's S = Q.K^T after its K).  Dependency-independent
    boundaries hide fill + pipeline; data-dependent boundaries whose
    stationary operand already exists (weights, earlier-written K-V)
    still hide the fill as a cross-level weight prefetch.
    ``serial_cycles`` itself equals the per-stage counted totals, which
    each cross-validate against ``simulate()``.  Hidden cycles at a
    *level boundary* are attributed to the incoming round's level, so
    single-stage levels may legitimately report ``overlapped < serial``.
    """

    levels: List[LevelTiming]

    @property
    def serial_cycles(self) -> int:
        return sum(lv.serial_cycles for lv in self.levels)

    @property
    def overlapped_cycles(self) -> int:
        return sum(lv.overlapped_cycles for lv in self.levels)

    @property
    def hidden_cycles(self) -> int:
        return self.serial_cycles - self.overlapped_cycles

    @property
    def speedup(self) -> float:
        if self.overlapped_cycles == 0:
            return 1.0
        return self.serial_cycles / self.overlapped_cycles

    @property
    def ok(self) -> bool:
        return all(0 <= lv.overlapped_cycles <= lv.serial_cycles
                   for lv in self.levels)

    def __str__(self) -> str:
        return (f"Pipeline[{len(self.levels)} levels] serial="
                f"{self.serial_cycles} overlapped={self.overlapped_cycles} "
                f"({self.speedup:.3f}x, {self.hidden_cycles} hidden)")


def compute_pipeline(
    program: Program,
    rounds_by_stage: Dict[str, List[CycleBreakdown]],
) -> PipelineReport:
    """Overlapped-round schedule from per-round critical paths.

    Levels serialize for *dependent* work; within a level, the stages'
    rounds interleave round-robin.  Two overlap rules apply at every
    boundary between rounds of different stages (within a level *and*
    across level boundaries):

    * **no dependency path** from the outgoing stage to the incoming one
      — the incoming round's fill + pipeline ramp hides under the
      outgoing round's streaming + drain
      (:func:`repro_torch.core.analytical.boundary_overlap_cycles`): in a
      merged batch graph (or a split projection the next stage never
      consumes — ``attn_score`` after ``v_proj``), the first round of a
      level can start filling while the previous level's last, unrelated
      round still streams;
    * **data-dependent, stationary operand independent** — the incoming
      stage consumes the outgoing one, but its *stationary* operand does
      not (``program.stationary_blockers()``): the stationary tiles
      already exist in memory, so their fill prefetches into the double
      buffer under the outgoing round's streaming + drain
      (:func:`repro_torch.core.analytical.weight_prefetch_overlap_cycles`) —
      only the pipeline ramp, coupled to the not-yet-produced streamed
      input, stays exposed.

    Rounds of the same stage never overlap (they share the stage's psum
    banks and stationary buffers), and a boundary whose stationary
    operand is itself produced by the outgoing stage (attention's
    S = Q.K^T after the K it consumes) hides nothing, so the overlapped
    sum can never beat the streamed work — ``overlapped <= serial``
    stays the program-level gate.
    """
    ancestors = program.ancestors()
    w_blockers = program.stationary_blockers()
    levels: List[LevelTiming] = []
    prev: Optional[Tuple[str, CycleBreakdown]] = None
    for level in program.levels():
        names = tuple(s.name for s in level)
        seqs = [rounds_by_stage.get(n, []) for n in names]
        serial = sum(b.total for seq in seqs for b in seq)
        # round-robin interleave: stage1 r0, stage2 r0, ..., stage1 r1, ...
        order: List[Tuple[str, CycleBreakdown]] = []
        for tier in range(max((len(s) for s in seqs), default=0)):
            for name, seq in zip(names, seqs):
                if tier < len(seq):
                    order.append((name, seq[tier]))
        hidden = 0
        for name, nb in order:
            if prev is not None:
                pname, pb = prev
                if pname != name:
                    if pname not in ancestors.get(name, ()):
                        hidden += boundary_overlap_cycles(
                            pb.stream, nb.fill, nb.pipeline,
                            prev_drain=pb.drain,
                        )
                    elif pname not in w_blockers.get(name, ()):
                        hidden += weight_prefetch_overlap_cycles(
                            pb.stream, nb.fill, prev_drain=pb.drain,
                        )
            prev = (name, nb)
        levels.append(LevelTiming(names, serial, serial - hidden))
    return PipelineReport(levels=levels)


# --------------------------------------------------------------------------- #
# ProgramReport
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ProgramReport:
    """Everything one ``Machine.run(program)`` produced."""

    program: Program
    stage_reports: Dict[str, "RunReport"]   # topological order
    backend: str
    pipeline: Optional[PipelineReport] = None

    def __getitem__(self, name: str) -> "RunReport":
        return self.stage_reports[name]

    @property
    def outputs(self) -> Dict[str, np.ndarray]:
        return {n: r.outputs for n, r in self.stage_reports.items()}

    @property
    def serial_cycles(self) -> int:
        """Counted cycles with stages strictly serialized (sum of the
        per-stage critical paths)."""
        return sum(r.total_cycles for r in self.stage_reports.values())

    @property
    def total_cycles(self) -> int:
        """Overlapped cycles under a pipelined backend, serial otherwise."""
        if self.pipeline is not None:
            return self.pipeline.overlapped_cycles
        return self.serial_cycles

    @property
    def validations(self) -> List[object]:
        return [v for r in self.stage_reports.values()
                for v in r.validations]

    @property
    def ok(self) -> bool:
        stages_ok = all(r.ok for r in self.stage_reports.values())
        return stages_ok and (self.pipeline is None or self.pipeline.ok)

    def __str__(self) -> str:
        lines = [f"ProgramReport[{len(self.stage_reports)} stages] "
                 f"backend={self.backend}"]
        lines += [f"  {r}" for r in self.stage_reports.values()]
        if self.pipeline is not None:
            lines.append(f"  {self.pipeline}")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# Lowering builders
# --------------------------------------------------------------------------- #

def _grouped(arr: np.ndarray, heads: int, group_size: int) -> np.ndarray:
    """Replicate per-KV-head matrices across their GQA group: instance i
    (query head) uses group i // group_size — the data behind the KV
    multicast (the tracer fetches each group's tiles once)."""
    return arr[np.arange(heads) // max(group_size, 1)]


def lower_attention(
    spec: AttentionSpec,
    *,
    x: Optional[np.ndarray] = None,
    seed: int = 0,
    split_qkv: bool = False,
) -> Program:
    """Lower a full attention block to a Program: QKV projection(s) ->
    act-to-act scores (Q @ K^T, KV multicast across GQA groups) ->
    softmax -> act-to-act output (A @ V) -> output projection.

    With ``split_qkv`` the projections become three independent stages
    (q_proj / k_proj / v_proj) sharing the streamed input — V is not
    needed until attn_output, so the graph's first level is a real
    antichain and a pipelining executor has rounds to overlap.  The
    default keeps the paper's fused qkv_proj stage, making the graph a
    pure chain; even there the attn_output and out_proj boundaries hide
    their fill as cross-level weight prefetch (their stationary operands
    — V written back at qkv time, the O-weights — exist before the
    streamed input does), while qkv -> attn_score hides nothing (its
    stationary K IS qkv's output).
    """
    h, g, hd, s = spec.heads, spec.kv_heads, spec.head_dim, spec.seq_len
    gs = spec.group_size
    if h % max(g, 1):
        raise ValueError(f"heads={h} not divisible by kv_heads={g}")
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.integers(-8, 9, size=(s, spec.hidden)).astype(np.int8)
    lo, hi = {2: (-1, 2), 4: (-8, 8)}.get(spec.weight_bits, (-8, 9))
    wqkv = rng.integers(lo, hi, size=(h + 2 * g, spec.hidden, hd)) \
        .astype(np.int8)
    wo = rng.integers(lo, hi, size=(1, h * hd, spec.hidden)).astype(np.int8)
    wl = attention_workloads(spec)   # [qkv, score, output, out_proj]

    # int8 Q times int8 K^T: map raw scores into softmax's active range
    score_scale = 1.0 / (127.0 * 127.0 * math.sqrt(hd))

    def k_transposed(out: np.ndarray) -> np.ndarray:
        """KV-head K outputs -> per-query-head stationary [h, hd, s]."""
        kq = requantize_int8(out)
        return _grouped(np.transpose(kq, (0, 2, 1)), h, gs)

    def v_grouped(out: np.ndarray) -> np.ndarray:
        return _grouped(requantize_int8(out), h, gs)

    def concat_heads(out: np.ndarray) -> np.ndarray:
        """[h, s, hd] -> requantized [s, h*hd] rows for the O-projection."""
        return requantize_int8(
            np.transpose(out, (1, 0, 2)).reshape(out.shape[1], h * hd)
        )

    prog = Program()
    if split_qkv:
        per = dict(m=s, k=spec.hidden, weight_bits=spec.weight_bits,
                   shared_input=True, mapping=wl[0].mapping,
                   layers=spec.layers)
        prog.add(ProgramStage(
            name=Q_PROJ, x=x, w=wqkv[:h],
            workload=GEMMWorkload(stage=Q_PROJ, n=hd, count=h, **per),
        ))
        prog.add(ProgramStage(
            name=K_PROJ, x=x, w=wqkv[h:h + g],
            workload=GEMMWorkload(stage=K_PROJ, n=hd, count=g, **per),
        ))
        prog.add(ProgramStage(
            name=V_PROJ, x=x, w=wqkv[h + g:],
            workload=GEMMWorkload(stage=V_PROJ, n=hd, count=g, **per),
        ))
        q_src, k_src, v_src = Q_PROJ, K_PROJ, V_PROJ
        q_of = requantize_int8
        k_of, v_of = k_transposed, v_grouped
    else:
        prog.add(ProgramStage(name=QKV_PROJ, workload=wl[0], x=x, w=wqkv))
        q_src = k_src = v_src = QKV_PROJ

        def q_of(out):
            return requantize_int8(out[:h])

        def k_of(out):
            return k_transposed(out[h:h + g])

        def v_of(out):
            return v_grouped(out[h + g:])

    prog.add(ProgramStage(
        name=ATTN_SCORE, workload=wl[1],
        x=Ref(q_src, q_of), w=Ref(k_src, k_of), w_source=STATIONARY_ACT,
    ))
    prog.add(ProgramStage(
        name=ATTN_OUTPUT, workload=wl[2],
        x=Ref(ATTN_SCORE, lambda o: softmax_int8(o, scale=score_scale)),
        w=Ref(v_src, v_of), w_source=STATIONARY_ACT,
    ))
    prog.add(ProgramStage(
        name=OUT_PROJ, workload=wl[3],
        x=Ref(ATTN_OUTPUT, concat_heads), w=wo,
    ))
    prog.validate()
    return prog


def _next_layer_rows(out: np.ndarray) -> np.ndarray:
    """The cross-layer link: layer ``l``'s final ``[1, m, d_model]``
    output requantized into the int8 rows layer ``l+1``'s QKV streams."""
    return requantize_int8(out[0])


def _lower_step_layer(
    by_stage: Dict[str, object],
    *,
    m: int,
    contexts: Tuple[int, ...],
    heads: int,
    kv_heads: int,
    head_dim: int,
    attn_layers: int,
    proj_layer_div: int,
    seed: int,
    layer: int,
    ltag: str,
    x_link: Optional[str],
    operands: bool,
    page_tokens: int = 0,
) -> Tuple[Program, str]:
    """One explicit transformer layer of a serve-step graph.

    Stage names carry ``ltag`` (empty for layer 0); per-slot attention
    subgraphs are built standalone and folded in via
    :meth:`Program.merge`, hanging off the shared (batched) projection
    stages.  ``x_link`` names the previous layer's final stage — its
    requantized output rows stream into this layer's QKV (the explicit
    cross-layer dependency).  With ``operands=False`` the graph is a
    *skeleton*: no arrays are synthesized and every data edge becomes an
    ``after`` control dependency — same names, workloads, levels, and
    ancestry, but only schedulable, not executable (the serve backend's
    per-step overlap computation needs nothing more).  Returns the layer
    program and the bare name of its final stage (the next layer's link
    target, before ``ltag``).
    """
    rows = m // len(contexts) if contexts else m
    gs = max(heads // max(kv_heads, 1), 1)
    rng = np.random.default_rng(seed if layer == 0 else (seed, layer)) \
        if operands else None

    def synth_x(k: int) -> Optional[np.ndarray]:
        if not operands:
            return None
        return rng.integers(-8, 9, size=(m, k)).astype(np.int8)

    def sized(op) -> GEMMWorkload:
        return dataclasses.replace(
            op.workload, m=m, layers=op.workload.layers // proj_layer_div,
        )

    def stage(name, workload, x, w, deps, **kw) -> ProgramStage:
        """Concrete stage, or its skeleton twin (deps as ``after``)."""
        if operands:
            return ProgramStage(name=name, workload=workload, x=x, w=w,
                                **kw)
        return ProgramStage(name=name, workload=workload,
                            after=tuple(deps), **kw)

    prog = Program()
    qkv = by_stage.get(QKV_PROJ)
    attended = bool(contexts)
    qkv_name = QKV_PROJ + ltag
    if qkv is not None:
        prog.add(stage(
            qkv_name, sized(qkv),
            (synth_x(qkv.workload.k) if x_link is None
             else Ref(x_link, _next_layer_rows)),
            qkv.weights,
            (x_link,) if x_link is not None else (),
        ))

    if contexts and qkv is None:
        raise ValueError(
            "attention lowering threads Q rows out of a qkv_proj "
            "projection; none among the given ops"
        )
    out_names: List[str] = []
    score_scale = 1.0 / (127.0 * 8.0 * math.sqrt(max(head_dim, 1)))
    slot_progs: List[Program] = []
    for j, t in enumerate(contexts):
        # per-slot KV cache: one K/V matrix per KV head, synthetic int8
        # (the engine's real cache lives inside the jitted graph)
        if operands:
            slot_rng = np.random.default_rng(
                (seed, j, t) if layer == 0 else (seed, layer, j, t))
            k_cache = slot_rng.integers(
                -8, 9, size=(kv_heads, t, head_dim)).astype(np.int8)
            v_cache = slot_rng.integers(
                -8, 9, size=(kv_heads, t, head_dim)).astype(np.int8)
        score_wl, out_wl = decode_attention_workloads(
            heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            context=t, m=rows, layers=attn_layers,
            page_tokens=page_tokens,
        )
        lo_row, hi_row = j * rows, (j + 1) * rows

        def q_rows(out: np.ndarray, lo=lo_row, hi=hi_row) -> np.ndarray:
            return requantize_int8(out[:heads, lo:hi, :])

        # standalone slot subgraph: bare stage names, external ref to the
        # shared projection — Program.merge retags it into the batch graph
        slot_progs.append(Program([
            stage(
                ATTN_SCORE, score_wl,
                Ref(qkv_name, q_rows),
                (_grouped(np.transpose(k_cache, (0, 2, 1)), heads, gs)
                 if operands else None),
                (qkv_name,), w_source=STATIONARY_ACT,
            ),
            stage(
                ATTN_OUTPUT, out_wl,
                Ref(ATTN_SCORE,
                    lambda o, sc=score_scale: softmax_int8(o, scale=sc)),
                _grouped(v_cache, heads, gs) if operands else None,
                (ATTN_SCORE,), w_source=STATIONARY_ACT,
            ),
        ]))
    if slot_progs:
        single = len(slot_progs) == 1
        tags = [ltag] if single else \
            [f"[{j}]{ltag}" for j in range(len(slot_progs))]
        for st in Program.merge(slot_progs, tags=tags):
            prog.add(st)
        out_names = [ATTN_OUTPUT + tag for tag in tags]

    def concat_slots(*outs: np.ndarray) -> np.ndarray:
        rows_ = [np.transpose(o, (1, 0, 2)).reshape(o.shape[1],
                                                    heads * head_dim)
                 for o in outs]
        return requantize_int8(np.concatenate(rows_, axis=0))

    last = QKV_PROJ
    o_proj = by_stage.get(OUT_PROJ)
    if o_proj is not None:
        prog.add(stage(
            OUT_PROJ + ltag, sized(o_proj),
            (Ref(tuple(out_names), concat_slots) if attended
             else synth_x(o_proj.workload.k)),
            o_proj.weights,
            tuple(out_names) if attended else (),
        ))
        last = OUT_PROJ

    # SwiGLU MLP: up branches share the post-attention rows, down consumes
    # the combined gate*value — serve-side stage names from legion_backend.
    mlp_up = by_stage.get("mlp_up")
    mlp_down = by_stage.get("mlp_down")
    if mlp_up is not None:
        prog.add(stage(
            "mlp_up" + ltag, sized(mlp_up),
            (Ref(OUT_PROJ + ltag, lambda o: requantize_int8(o[0]))
             if o_proj is not None else synth_x(mlp_up.workload.k)),
            mlp_up.weights,
            (OUT_PROJ + ltag,) if o_proj is not None else (),
        ))
    if mlp_down is not None:
        prog.add(stage(
            "mlp_down" + ltag, sized(mlp_down),
            (Ref("mlp_up" + ltag, swiglu_int8) if mlp_up is not None
             else synth_x(mlp_down.workload.k)),
            mlp_down.weights,
            ("mlp_up" + ltag,) if mlp_up is not None else (),
        ))
        last = "mlp_down"
    return prog, last


def lower_serve_step(
    projections: Sequence,
    *,
    m: int,
    contexts: Sequence[int] = (),
    heads: int = 0,
    kv_heads: int = 0,
    head_dim: int = 0,
    layers: int = 1,
    seed: int = 0,
    explicit_layers: int = 1,
    operands: bool = True,
    page_tokens: int = 0,
    page_tables: Optional[Sequence[Sequence[int]]] = None,
) -> Program:
    """Lower one serving step — projections AND attention — to a Program.

    ``projections`` are ``(workload, weights)`` records (duck-typed
    ``repro_torch.serve.legion_backend.ProjectionOp``); their template ``m`` is
    replaced with the step's row count.  ``contexts`` gives each slot's KV
    context length: one entry per decode slot (``m`` slots x 1 row), or a
    single entry ``(m,)`` for prefill (one slot x ``m`` rows).  Per slot,
    the KV-cache matrices become *stationary activation* operands with
    position-dependent K/N (score ``[rows, hd] @ [hd, t]``, output
    ``[rows, t] @ [t, hd]``), shared across each GQA group.  Outputs
    thread through the graph: qkv -> score -> softmax -> output ->
    O-proj -> SwiGLU mlp, so the whole step is one dependency graph.

    ``explicit_layers`` spans the program over that many *explicit*
    transformer layers (stage names gain an ``@l`` suffix for layers
    ``l >= 1``): layer ``l+1``'s QKV streams layer ``l``'s requantized
    mlp_down (or out_proj) output through a real :class:`Ref` — the
    cross-layer data dependency the ``layers``-scalar shortcut elides.
    Every stage workload's ``layers`` multiplier divides by
    ``explicit_layers`` (must divide evenly), so whole-model tallies are
    unchanged while the graph exposes the layer structure to a
    :class:`~repro_torch.legion.machine.PipelinedExecutor`.

    ``operands=False`` builds the *skeleton* graph only — identical
    names, workloads, levels, and ancestry, but no synthesized arrays
    (data edges become ``after`` control deps).  Schedulable (the serve
    backend's per-decode-step overlap computation), not executable.

    With ``page_tokens > 0`` each slot's stationary K/V operands are
    annotated as block-allocated in ``page_tokens``-token pages: the
    runtime fetches them page-granularly (per-page ``on_page_fetch``
    events, last-page padding accounted as traffic waste) instead of as
    idealized contiguous reads.  ``page_tables`` optionally pins the
    engine's physical page ids — one table per slot, whose length must be
    exactly ``ceil(context / page_tokens)`` (the allocator and the
    lowered graph must agree on how many pages back each context).
    """
    by_stage = {op.workload.stage: op for op in projections}
    contexts = tuple(int(t) for t in contexts)
    if page_tokens < 0:
        raise ValueError(f"page_tokens must be >= 0, got {page_tokens}")
    if page_tables is not None:
        if not page_tokens:
            raise ValueError("page_tables given without page_tokens")
        if len(page_tables) != len(contexts):
            raise ValueError(
                f"{len(page_tables)} page tables for {len(contexts)} slots"
            )
        for j, (tab, t) in enumerate(zip(page_tables, contexts)):
            need = -(-int(t) // page_tokens)
            if len(tab) != need:
                raise ValueError(
                    f"slot {j}: page table has {len(tab)} pages, context "
                    f"{t} at {page_tokens} tokens/page needs {need}"
                )
    if explicit_layers < 1:
        raise ValueError(
            f"explicit_layers must be >= 1, got {explicit_layers}"
        )
    if explicit_layers > 1:
        if "mlp_down" not in by_stage and OUT_PROJ not in by_stage:
            raise ValueError(
                "explicit_layers > 1 chains layer l+1's qkv off layer l's "
                "mlp_down (or out_proj) output; neither among the given ops"
            )
        if QKV_PROJ not in by_stage:
            raise ValueError(
                "explicit_layers > 1 needs a qkv_proj op to stream the "
                "previous layer's output into"
            )
        if layers % explicit_layers:
            raise ValueError(
                f"{layers} attention layers cannot split into "
                f"{explicit_layers} explicit layers"
            )
        for op in projections:
            if op.workload.layers % explicit_layers:
                raise ValueError(
                    f"{op.workload.stage}: {op.workload.layers} model "
                    f"layers cannot split into {explicit_layers} explicit "
                    f"layers"
                )
    if contexts:
        if not (heads and kv_heads and head_dim):
            raise ValueError(
                "attention lowering needs heads/kv_heads/head_dim"
            )
        if m % len(contexts):
            raise ValueError(
                f"{m} step rows cannot split over {len(contexts)} slots"
            )
        if heads % kv_heads:
            raise ValueError(
                f"heads={heads} not divisible by kv_heads={kv_heads}"
            )

    prog = Program()
    link: Optional[str] = None
    for layer in range(explicit_layers):
        ltag = "" if layer == 0 else f"@{layer}"
        layer_prog, last = _lower_step_layer(
            by_stage, m=m, contexts=contexts, heads=heads,
            kv_heads=kv_heads, head_dim=head_dim,
            attn_layers=layers // explicit_layers,
            proj_layer_div=explicit_layers, seed=seed, layer=layer,
            ltag=ltag, x_link=link, operands=operands,
            page_tokens=page_tokens,
        )
        for st in layer_prog:
            prog.add(st)
        link = last + ltag
    prog.validate()
    return prog


def lower_serve_batch(
    projections: Sequence,
    *,
    contexts: Sequence[int],
    heads: int,
    kv_heads: int,
    head_dim: int,
    layers: int = 1,
    rows_per_slot: int = 1,
    seed: int = 0,
    explicit_layers: int = 1,
    page_tokens: int = 0,
    page_tables: Optional[Sequence[Sequence[int]]] = None,
) -> Program:
    """One decode step's merged batch graph: every active slot's attention
    program interleaved as an antichain under shared projection stages.

    The continuous-batching shape: ``len(contexts)`` slots decode together
    (``rows_per_slot`` rows each — 1 for decode), the projections run once
    batched over all ``m = slots * rows_per_slot`` rows, and each slot's
    score/output pair attends its own KV context — dependency-independent
    of every other slot's, so a
    :class:`~repro_torch.legion.machine.PipelinedExecutor` hides fill/pipeline
    ramps across slots.  Thin, named front door over
    :func:`lower_serve_step` (which accepts the same shapes): this is the
    builder :class:`~repro_torch.serve.legion_backend.LegionServeBackend` uses
    for its engine-view overlapped latency.
    """
    contexts = tuple(int(t) for t in contexts)
    if not contexts:
        raise ValueError("lower_serve_batch needs at least one slot context")
    if rows_per_slot < 1:
        raise ValueError(f"rows_per_slot must be >= 1, got {rows_per_slot}")
    return lower_serve_step(
        projections, m=len(contexts) * rows_per_slot, contexts=contexts,
        heads=heads, kv_heads=kv_heads, head_dim=head_dim, layers=layers,
        seed=seed, explicit_layers=explicit_layers,
        page_tokens=page_tokens, page_tables=page_tables,
    )


def lower_serve_mixed(
    projections: Sequence,
    *,
    chunks: Sequence[Tuple[int, int]],
    decode_contexts: Sequence[int] = (),
    heads: int,
    kv_heads: int,
    head_dim: int,
    layers: int = 1,
    seed: int = 0,
    operands: bool = True,
    page_tokens: int = 0,
    chunk_page_tables: Optional[Sequence[Sequence[int]]] = None,
    decode_page_tables: Optional[Sequence[Sequence[int]]] = None,
) -> Program:
    """One *mixed-phase* engine step: in-flight prefill chunks merged with
    the batched decode slots into a single step graph.

    ``chunks`` gives each active prefill chunk's ``(rows, context)`` shape
    — ``rows`` prompt tokens written this step, attending ``context``
    cache entries (the chunk's start offset plus its rows; earlier chunks
    of the same prompt already sit in the cache).  ``decode_contexts`` is
    the usual per-slot context tuple of the step's batched decode (empty
    when every slot is still prefilling).  Each phase lowers through
    :func:`lower_serve_step` and the parts merge via :meth:`Program.merge`
    with ``{p<i>}`` / ``{d}`` name tags — the TensorRT-LLM in-flight
    batching shape: context-phase and generation-phase work share one
    scheduled graph, so :func:`compute_pipeline` overlaps chunk rounds
    against decode rounds exactly as it does across decode slots.

    ``operands=False`` builds the schedulable skeleton (the serve
    backend's per-step hot path); with operands the merged graph is
    executable and its measured traffic/cycles equal the sum of its
    phase parts.
    """
    chunks = tuple((int(r), int(t)) for r, t in chunks)
    decode_contexts = tuple(int(t) for t in decode_contexts)
    if not chunks and not decode_contexts:
        raise ValueError(
            "lower_serve_mixed needs at least one prefill chunk or decode "
            "slot"
        )
    for rows, t in chunks:
        if rows < 1 or t < rows:
            raise ValueError(
                f"chunk ({rows}, {t}): need rows >= 1 and context >= rows "
                f"(a chunk attends at least its own rows)"
            )
    if chunk_page_tables is not None and \
            len(chunk_page_tables) != len(chunks):
        raise ValueError(
            f"{len(chunk_page_tables)} chunk page tables for "
            f"{len(chunks)} chunks"
        )
    parts: List[Program] = []
    tags: List[str] = []
    for i, (rows, t) in enumerate(chunks):
        parts.append(lower_serve_step(
            projections, m=rows, contexts=(t,), heads=heads,
            kv_heads=kv_heads, head_dim=head_dim, layers=layers,
            seed=seed, operands=operands, page_tokens=page_tokens,
            page_tables=(None if chunk_page_tables is None
                         else (chunk_page_tables[i],)),
        ))
        tags.append(f"{{p{i}}}")
    if decode_contexts:
        parts.append(lower_serve_step(
            projections, m=len(decode_contexts), contexts=decode_contexts,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            layers=layers, seed=seed, operands=operands,
            page_tokens=page_tokens, page_tables=decode_page_tables,
        ))
        tags.append("{d}")
    merged = Program.merge(parts, tags=tags)
    merged.validate()
    return merged
