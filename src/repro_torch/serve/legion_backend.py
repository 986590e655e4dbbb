"""Serve-path Legion backend — serving steps executed through the runtime.

The serving engine runs whole-model PyTorch steps; the accelerator models
never saw them.  This bridge closes that gap the way TensorRT-LLM routes
per-step GEMMs through an engine graph: it extracts the projection matrices
(``wq/wk/wv/wo`` and the SwiGLU ``w1/w2/w3``) from the engine's params and
lowers every prefill / decode step to **one**
:class:`~repro_torch.legion.program.Program` — the projection stages *and* the
act-to-act attention stages, with each slot's KV-cache matrices as
stationary activation operands whose K/N depend on the slot's position
(context length ``t`` at decode) and GQA groups sharing one multicast
fetch.  The program executes through a
:class:`~repro_torch.legion.machine.Machine` session, so traced serving traffic
produces measured **byte and cycle tallies per request covering the full
step**, cross-validatable against ``simulate()`` on the very same
workloads.  Pass ``executor=`` (any
:class:`~repro_torch.legion.machine.ExecutorBackend`, e.g.
``PipelinedExecutor``) to choose how the step programs run, ``device=``
where their tile GEMMs run (default: the CUDA card, through the bitlinear
kernel), and ``granularity=`` whether each (K-window, N-tile) pass
(``"window"``) or each Legion assignment (``"kernel"``) is one launch.

One representative layer executes numerically (the weights are the engine's
actual ternary-quantized matrices, re-extracted to int8); tallies scale by
the model's layer count — the same one-layer-times-L convention as
``repro_torch.legion.trace.cross_validate``.  The streamed input and the KV
cache are synthetic int8 (the engine's real activations live inside the
model forward), but the intermediate activations thread through the program graph
(qkv -> score -> softmax -> output -> O-proj -> SwiGLU mlp), so the GEMMs
are numerically real — every stage output is checked against the plain
``x @ w`` reference — while the *shapes, weights, plans, dependencies,
traffic, and cycles* are the serving step's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.simulator import simulate
from repro_torch.core.workloads import (
    ATTN_OUTPUT,
    ATTN_SCORE,
    GEMMWorkload,
    HEAD_PER_UNIT,
    MLP_DOWN,
    MLP_UP,
    N_PARTITION,
    OUT_PROJ,
    QKV_PROJ,
    decode_attention_workloads,
)
from repro_torch.device import DeviceLike
from repro_torch.legion.latency import (
    CycleBreakdown,
    CycleValidation,
    merge_round_criticals,
)
from repro_torch.legion.machine import ExecutorBackend, Machine
from repro_torch.legion.program import (
    STATIONARY_ACT,
    Program,
    ProgramStage,
    Ref,
    compute_pipeline,
    lower_serve_mixed,
    lower_serve_step,
    softmax_int8,
)
from repro_torch.legion.trace import StageValidation, TrafficTotals

# Serve-side stage names beyond the paper's four attention stages (the
# SwiGLU MLP projections are GEMMs too, and at decode they dominate bytes)
# now live in core.workloads — MLP_UP / MLP_DOWN are imported above and
# stay re-exported here for existing call sites.

PREFILL = "prefill"
DECODE = "decode"
STEP = "step"            # in-flight: prefill chunks + decode, one event


@dataclasses.dataclass(frozen=True)
class ProjectionOp:
    """One serve-step GEMM family: template workload + stationary weights.

    ``workload.m`` is a placeholder (1); the backend replaces it with the
    step's row count (1 per decode token, prompt length for prefill).
    """

    workload: GEMMWorkload
    weights: np.ndarray          # [count, K, N] int8 (ternary)


@dataclasses.dataclass
class StageTally:
    traffic: TrafficTotals
    cycles: int = 0


@dataclasses.dataclass
class StepTally:
    """Measured totals of one serving step (all layers) through the runtime."""

    m: int                                # activation rows (tokens) executed
    gemms: int = 0                        # GEMM workloads lowered
    weight_bytes: float = 0.0
    act_bytes: float = 0.0
    psum_bytes: float = 0.0
    cycles: int = 0
    # Exposed weight-prefetch cycles (inside ``cycles``) — nonzero only
    # when the backend's Machine runs a finite mem_bw_bytes_per_cycle.
    stall_cycles: int = 0
    executed_passes: int = 0
    skipped_passes: int = 0
    # Paged-KV fetch accounting (zero for contiguous backends); the waste
    # is also folded into weight_bytes — see repro_torch.legion.trace.
    page_fetches: float = 0.0
    page_bytes: float = 0.0
    page_waste_bytes: float = 0.0
    stages: Dict[str, StageTally] = dataclasses.field(default_factory=dict)

    @property
    def mem_bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    @property
    def stall_frac(self) -> float:
        """Exposed-prefetch share of the step's cycles (0 = fully hidden)."""
        return self.stall_cycles / self.cycles if self.cycles else 0.0

    def seconds(self, freq_hz: float) -> float:
        return self.cycles / freq_hz

    def merge(self, other: "StepTally") -> None:
        """Fold another step into this one (engine-level accumulation)."""
        self.m += other.m
        self.gemms += other.gemms
        self.weight_bytes += other.weight_bytes
        self.act_bytes += other.act_bytes
        self.psum_bytes += other.psum_bytes
        self.cycles += other.cycles
        self.stall_cycles += other.stall_cycles
        self.executed_passes += other.executed_passes
        self.skipped_passes += other.skipped_passes
        self.page_fetches += other.page_fetches
        self.page_bytes += other.page_bytes
        self.page_waste_bytes += other.page_waste_bytes
        for stage, st in other.stages.items():
            agg = self.stages.setdefault(
                stage, StageTally(traffic=TrafficTotals()))
            agg.traffic.add(st.traffic)
            agg.cycles += st.cycles


@dataclasses.dataclass
class RequestTally:
    """Per-request accumulation across the request's prefill + decode steps."""

    uid: int
    prefill_tokens: int = 0
    decode_tokens: int = 0
    weight_bytes: float = 0.0
    act_bytes: float = 0.0
    psum_bytes: float = 0.0
    cycles: int = 0

    @property
    def mem_bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    def add(self, t: StepTally) -> None:
        self.weight_bytes += t.weight_bytes
        self.act_bytes += t.act_bytes
        self.psum_bytes += t.psum_bytes
        self.cycles += t.cycles


def _ternary_int8(w) -> np.ndarray:
    """Engine weights -> int8 ternary.  ``prepare_params`` serves values in
    {-gamma, 0, +gamma}; re-quantizing recovers the exact {-1, 0, 1} grid."""
    from repro_torch.quant.bitnet import quantize_weight_ternary

    q, _gamma = quantize_weight_ternary(
        torch.as_tensor(w).detach().to("cpu", torch.float32))
    return q.numpy()


def extract_projection_ops(
    model_cfg, params, *, layer: int = 0,
) -> List[ProjectionOp]:
    """Pull one layer's projection GEMMs out of stacked serve params.

    Returns the four serve-side GEMM families (qkv_proj, out_proj, mlp_up,
    mlp_down) with per-instance stationary matrices — per produced head for
    qkv (the scheduler's head-per-Legion unit of work), per SwiGLU branch
    for mlp_up — and ``layers=model_cfg.layers`` so downstream accounting
    scales one executed layer to the whole model.
    """
    blocks = params["blocks"]
    if "attn" not in blocks or "mlp" not in blocks:
        raise ValueError(
            "legion serve backend needs a dense transformer (attn + mlp "
            f"blocks); got block params {sorted(blocks)}"
        )
    if model_cfg.quantization != "bitnet":
        # _ternary_int8 would collapse real-valued served weights to
        # {-1, 0, 1} — tallies for a model the engine does not serve
        raise ValueError(
            "legion serve backend models ternary (BitNet) projections; "
            f"got quantization={model_cfg.quantization!r}"
        )
    hd = model_cfg.head_dim_
    heads, kv_heads = model_cfg.n_heads, model_cfg.kv_heads
    d_model, d_ff, layers = model_cfg.d_model, model_cfg.d_ff, model_cfg.layers

    attn = {k: _ternary_int8(blocks["attn"][k][layer])
            for k in ("wq", "wk", "wv", "wo")}
    mlp = {k: _ternary_int8(blocks["mlp"][k][layer])
           for k in ("w1", "w2", "w3")}

    def split_heads(w: np.ndarray, n: int) -> List[np.ndarray]:
        return [w[:, h * hd:(h + 1) * hd] for h in range(n)]

    qkv = np.stack(
        split_heads(attn["wq"], heads)
        + split_heads(attn["wk"], kv_heads)
        + split_heads(attn["wv"], kv_heads)
    )
    bits = 2
    return [
        ProjectionOp(
            GEMMWorkload(stage=QKV_PROJ, m=1, k=d_model, n=hd,
                         weight_bits=bits, count=heads + 2 * kv_heads,
                         shared_input=True, mapping=HEAD_PER_UNIT,
                         layers=layers),
            qkv,
        ),
        ProjectionOp(
            GEMMWorkload(stage=OUT_PROJ, m=1, k=heads * hd, n=d_model,
                         weight_bits=bits, count=1, mapping=N_PARTITION,
                         layers=layers),
            attn["wo"][None],
        ),
        ProjectionOp(
            GEMMWorkload(stage=MLP_UP, m=1, k=d_model, n=d_ff,
                         weight_bits=bits, count=2, shared_input=True,
                         mapping=N_PARTITION, layers=layers),
            np.stack([mlp["w1"], mlp["w3"]]),
        ),
        ProjectionOp(
            GEMMWorkload(stage=MLP_DOWN, m=1, k=d_ff, n=d_model,
                         weight_bits=bits, count=1, mapping=N_PARTITION,
                         layers=layers),
            mlp["w2"][None],
        ),
    ]


class LegionServeBackend:
    """Drives a ServeEngine's per-step GEMMs through the runtime.

    Attach to an engine (``backend.attach(engine)``) and every prefill /
    decode step is lowered to one :class:`~repro_torch.legion.program.Program`
    (projections AND, with ``attention=True``, the act-to-act attention
    stages over each slot's KV context) and executed.  Two views
    accumulate:

    * :attr:`totals` — **batch-accurate** engine-level totals: a batched
      decode over A active slots executes as one ``m=A`` step (stationary
      weights fetched once for the whole batch, like the hardware would),
      with one per-slot attention pair at each slot's own context length;
    * :attr:`per_request` — per-request **standalone** costs: each decode
      token is attributed its own ``m=1`` step at that token's context,
      as if the request were served alone.  Summing per-request tallies
      therefore *exceeds* ``totals`` whenever requests share a decode
      batch — that headroom is exactly the batching win, not
      double-counted hardware work.

    A third, **engine view** rides on the batched one: every decode step's
    merged batch graph (shared projections, per-slot attention antichain —
    ``repro_torch.legion.program.lower_serve_batch``'s shape) is scheduled
    through the pipelined overlap model, composed from the cached
    sub-program round criticals without re-executing anything.
    ``summary()`` reports ``overlapped_cycles_per_step`` (<= the serial
    sum, asserted) and the per-token overlapped cycles that
    :meth:`cache_budget` feeds into ``serve.kv_cache.plan``.

    Step tallies are cached compositionally: the context-independent
    projection part by row count ``m``, the attention pair by
    ``(rows, context)``, and the composed step by ``(m, contexts)`` —
    byte/cycle identical to executing the step's single Program (fresh
    per-stage instruments mean nothing dedups across stages), but a
    decode stream whose context advances every token re-executes only
    the two attention GEMMs, not the dominant projection/MLP stages.
    :meth:`step_program` still lowers the whole step to one graph (for
    the pipelined executor, or any caller wanting the full DAG).
    """

    def __init__(
        self,
        accel_cfg: AcceleratorConfig,
        model_cfg,
        params,
        *,
        layer: int = 0,
        seed: int = 0,
        check_outputs: bool = True,
        mem_bw_bytes_per_cycle: float = math.inf,
        executor: Optional[ExecutorBackend] = None,
        attention: bool = True,
        metrics=None,
        page_tokens: int = 0,
        device: DeviceLike = None,
        granularity: str = "window",
    ) -> None:
        self.cfg = accel_cfg
        self.model_cfg = model_cfg
        self.ops = extract_projection_ops(model_cfg, params, layer=layer)
        self.seed = seed
        self.check_outputs = check_outputs
        self.mem_bw = mem_bw_bytes_per_cycle
        self.attention = attention
        # Paged-KV pricing: annotate every attention stage's stationary
        # K/V operand as block-allocated in page_tokens-token pages, so
        # the runtime fires per-page fetch events and tallies the
        # last-page padding as traffic waste (0 = contiguous pricing).
        # Match the engine's PagedKVCache page size.
        if page_tokens < 0:
            raise ValueError(f"page_tokens must be >= 0, got {page_tokens}")
        self.page_tokens = page_tokens
        self.heads = model_cfg.n_heads
        self.kv_heads = model_cfg.kv_heads
        self.head_dim = model_cfg.head_dim_
        self.layers = model_cfg.layers
        # Duck-typed metrics registry (see repro_torch.obs.metrics
        # .MetricsRegistry); None disables serve_backend_* / kv_* metrics.
        self.metrics = metrics
        # One Machine session serves every step, its tile GEMMs on `device`
        self.machine = Machine(
            accel_cfg, backend=executor,
            mem_bw_bytes_per_cycle=mem_bw_bytes_per_cycle,
            device=device, granularity=granularity,
        )
        self.per_request: Dict[int, RequestTally] = {}
        self.totals = StepTally(m=0)     # batch-accurate engine totals
        self.prefill_steps = 0
        self.decode_steps = 0
        self._step_cache: Dict[Tuple[int, Tuple[int, ...]], StepTally] = {}
        self._proj_cache: Dict[int, StepTally] = {}          # by m
        self._attn_cache: Dict[Tuple[int, int], StepTally] = {}  # (rows, t)
        self._decode_cycles = 0          # standalone per-token accumulation
        self._decode_tokens = 0
        # Engine-view pipelining: per-node round criticals captured from the
        # cached sub-program executions (keyed by workload shape), and the
        # merged batch graph's serial/overlapped cycles per step shape.
        self._rounds: Dict[Tuple[str, int, int, int, int],
                           List[CycleBreakdown]] = {}
        self._pipeline_cache: Dict[Tuple[int, Tuple[int, ...]],
                                   Tuple[int, int]] = {}
        self._mixed_cache: Dict[tuple, Tuple[int, int]] = {}
        # Engine-view accumulators.  ``engine_steps`` counts the steps the
        # merged-graph schedule priced: every batched decode step in
        # legacy mode, every mixed (chunks + decode) step in in-flight
        # mode — so *_cycles_per_step covers prefill once chunks merge in.
        self.engine_steps = 0
        self._engine_serial_cycles = 0       # engine-view steps, serial
        self._engine_overlapped_cycles = 0   # same steps, pipelined
        # Decode-only engine view: the per-decode-token overlapped rate
        # (what cache_budget feeds kv_cache.plan) must not absorb prefill
        # cycles when mixed steps carry both phases.
        self._decode_serial_cycles = 0
        self._decode_overlapped_cycles = 0

    # ------------------------------------------------------------------ #
    def attach(self, engine) -> "LegionServeBackend":
        engine.step_observers.append(self.on_step)
        return self

    def on_step(self, event: dict) -> None:
        if event["kind"] == PREFILL:
            self.prefill_steps += 1
            tokens = event["tokens"]
            # prefill attends over its own prompt: one slot, context = m
            tally = self.step_tally(tokens, self._ctx((tokens,)))
            self.totals.merge(tally)
            req = self._request(event["uid"])
            req.prefill_tokens += tokens
            req.add(tally)
            if self.metrics is not None:
                self.metrics.counter("serve_backend_prefill_cycles") \
                    .inc(tally.cycles)
        elif event["kind"] == DECODE:
            self.decode_steps += 1
            uids = event["uids"]
            positions = event.get("positions", ())
            # context at this step: the cache holds pos entries and the
            # step writes + attends position pos -> t = pos + 1
            contexts = tuple(p + 1 for p in positions) \
                if len(positions) == len(uids) else (1,) * len(uids)
            # engine view: one batched m=len(uids) step (canonical slot
            # order so permuted batches share a cache entry)
            batch_ctx = tuple(sorted(contexts))
            self.totals.merge(
                self.step_tally(len(uids), self._ctx(batch_ctx))
            )
            # ... and the same step as a merged batch graph through the
            # pipelined schedule: per-slot attention rounds interleave, so
            # the engine-view latency is the overlapped one
            serial, overlapped = self.step_pipeline(len(uids), batch_ctx)
            self.engine_steps += 1
            self._engine_serial_cycles += serial
            self._engine_overlapped_cycles += overlapped
            self._decode_serial_cycles += serial
            self._decode_overlapped_cycles += overlapped
            self._record_step_metrics(serial, overlapped)
            self._attribute_decode(uids, contexts)
        elif event["kind"] == STEP:
            # in-flight: prefill chunks + the batched decode, one merged
            # step.  Tallies accumulate part-wise (the parts' caches also
            # hold every round the merged schedule needs); the engine view
            # prices the step as ONE merged mixed-phase graph.
            chunks = event.get("chunks", ())
            uids = event.get("uids", ())
            positions = event.get("positions", ())
            contexts = tuple(p + 1 for p in positions) \
                if len(positions) == len(uids) else (1,) * len(uids)
            batch_ctx = tuple(sorted(contexts))
            shapes = []
            for ch in chunks:
                rows = ch["tokens"]
                t = ch["pos0"] + rows        # chunk attends its prefix too
                shapes.append((rows, t))
                self.prefill_steps += 1
                tally = self.step_tally(rows, self._ctx((t,)))
                self.totals.merge(tally)
                req = self._request(ch["uid"])
                req.prefill_tokens += rows
                req.add(tally)
                if self.metrics is not None:
                    self.metrics.counter("serve_backend_prefill_cycles") \
                        .inc(tally.cycles)
            if uids:
                self.decode_steps += 1
                self.totals.merge(
                    self.step_tally(len(uids), self._ctx(batch_ctx)))
                d_serial, d_overlapped = self.step_pipeline(
                    len(uids), batch_ctx)
                self._decode_serial_cycles += d_serial
                self._decode_overlapped_cycles += d_overlapped
                self._attribute_decode(uids, contexts)
            serial, overlapped = self.step_pipeline_mixed(
                shapes, decode_m=len(uids), decode_contexts=batch_ctx)
            self.engine_steps += 1
            self._engine_serial_cycles += serial
            self._engine_overlapped_cycles += overlapped
            self._record_step_metrics(serial, overlapped)

    def _attribute_decode(self, uids, contexts) -> None:
        """Per-request standalone attribution: each decode token's own
        m=1 step cost at its context."""
        for uid, t in zip(uids, contexts):
            tally = self.step_tally(1, self._ctx((t,)))
            req = self._request(uid)
            req.decode_tokens += 1
            req.add(tally)
            self._decode_cycles += tally.cycles
            self._decode_tokens += 1
        if self.metrics is not None and self._decode_tokens:
            self.metrics.gauge("serve_cycles_per_decode_token").set(
                self._decode_cycles / self._decode_tokens)

    def _record_step_metrics(self, serial: int, overlapped: int) -> None:
        if self.metrics is None:
            return
        m = self.metrics
        m.counter("serve_backend_serial_cycles").inc(serial)
        m.counter("serve_backend_overlapped_cycles").inc(overlapped)
        m.histogram("serve_step_overlap_x").observe(
            serial / overlapped if overlapped else 1.0)

    def _request(self, uid: int) -> RequestTally:
        return self.per_request.setdefault(uid, RequestTally(uid=uid))

    def _ctx(self, contexts: Tuple[int, ...]) -> Tuple[int, ...]:
        return contexts if self.attention else ()

    # ------------------------------------------------------------------ #
    def workloads(
        self, m: int, contexts: Sequence[int] = (),
    ) -> List[GEMMWorkload]:
        """The step's GEMM workloads (projections + per-slot attention) —
        what :meth:`cross_validate` simulates."""
        out = [dataclasses.replace(op.workload, m=m) for op in self.ops]
        contexts = tuple(contexts)
        if contexts and m % len(contexts):
            # same constraint lower_serve_step enforces — the analytic
            # workloads must correspond to an executable step program
            raise ValueError(
                f"{m} step rows cannot split over {len(contexts)} slots"
            )
        rows = m // len(contexts) if contexts else m
        for t in contexts:
            out.extend(decode_attention_workloads(
                heads=self.heads, kv_heads=self.kv_heads,
                head_dim=self.head_dim, context=t, m=rows,
                layers=self.layers, page_tokens=self.page_tokens,
            ))
        return out

    def step_program(self, m: int, contexts: Sequence[int] = (), *,
                     explicit_layers: int = 1) -> Program:
        """Lower one serving step (``m`` rows, per-slot KV contexts) to a
        Program: projections and attention as one dependency graph —
        ``explicit_layers > 1`` spans it over explicit transformer layers
        (layer ``l+1``'s QKV streams layer ``l``'s MLP output)."""
        return lower_serve_step(
            self.ops, m=m, contexts=self._ctx(tuple(contexts)),
            heads=self.heads, kv_heads=self.kv_heads,
            head_dim=self.head_dim, layers=self.layers, seed=self.seed,
            explicit_layers=explicit_layers, page_tokens=self.page_tokens,
        )

    def _tally_program(self, program: Program, m: int) -> StepTally:
        """Execute a (sub-)program and fold its stage reports into a tally."""
        report = self.machine.run(program,
                                  check_outputs=self.check_outputs,
                                  validate=False)
        tally = StepTally(m=m)
        for name, rep in report.stage_reports.items():
            w = rep.workload
            # capture the node's per-round critical paths by workload shape
            # — step_pipeline composes merged-graph schedules from these
            # without re-executing (rounds depend only on plan geometry);
            # cycle cells key by the node name (plan_stage stage= override)
            self._rounds[(w.stage, w.m, w.k, w.n, w.count)] = \
                rep.cycles.round_criticals()[name]
            cycles = rep.cycles.total_cycles * w.layers
            traffic = rep.trace.totals.scaled(w.layers)
            tally.gemms += 1
            tally.weight_bytes += traffic.weight_bytes
            tally.act_bytes += traffic.act_bytes
            tally.psum_bytes += traffic.psum_bytes
            tally.cycles += cycles
            tally.stall_cycles += \
                rep.cycles.stage_breakdown()[name].stall * w.layers
            tally.executed_passes += rep.cycles.executed_passes * w.layers
            tally.skipped_passes += rep.cycles.skipped_passes * w.layers
            tally.page_fetches += traffic.page_fetches
            tally.page_bytes += traffic.page_bytes
            tally.page_waste_bytes += traffic.page_waste_bytes
            # tallies aggregate by workload stage family ("attn_score"),
            # not per-slot node name ("attn_score[2]")
            agg = tally.stages.setdefault(
                w.stage, StageTally(traffic=TrafficTotals()))
            agg.traffic.add(traffic)
            agg.cycles += cycles
        return tally

    def _attention_program(self, rows: int, t: int) -> Program:
        """The score -> softmax -> output pair alone, at context ``t``:
        synthetic Q rows and per-group K/V stationary activations — the
        same shapes, plans, and threading as the full step's attention
        stages, executable without re-running the projections."""
        score_wl, out_wl = decode_attention_workloads(
            heads=self.heads, kv_heads=self.kv_heads,
            head_dim=self.head_dim, context=t, m=rows, layers=self.layers,
            page_tokens=self.page_tokens,
        )
        rng = np.random.default_rng((self.seed, rows, t))
        q = rng.integers(-8, 9, size=(self.heads, rows, self.head_dim)) \
            .astype(np.int8)
        kv = rng.integers(
            -8, 9, size=(2, self.kv_heads, t, self.head_dim)).astype(np.int8)
        group = np.arange(self.heads) // max(self.heads // self.kv_heads, 1)
        scale = 1.0 / (8.0 * 8.0 * math.sqrt(self.head_dim))
        return Program([
            ProgramStage(
                name=ATTN_SCORE, workload=score_wl, x=q,
                w=np.transpose(kv[0], (0, 2, 1))[group],
                w_source=STATIONARY_ACT,
            ),
            ProgramStage(
                name=ATTN_OUTPUT, workload=out_wl,
                x=Ref(ATTN_SCORE, lambda o: softmax_int8(o, scale=scale)),
                w=kv[1][group], w_source=STATIONARY_ACT,
            ),
        ])

    def step_tally(
        self, m: int, contexts: Sequence[int] = (),
    ) -> StepTally:
        """One serving step's measured tally for ``m`` activation rows.

        Composed from cached sub-program executions (projections by ``m``,
        attention by ``(rows, context)``) — identical bytes/cycles to
        running :meth:`step_program`'s single graph, without re-executing
        the context-independent stages every time a context advances.
        """
        contexts = self._ctx(tuple(contexts))
        if contexts and m % len(contexts):
            raise ValueError(
                f"{m} step rows cannot split over {len(contexts)} slots"
            )
        key = (m, contexts)
        if key in self._step_cache:
            return self._step_cache[key]
        if m not in self._proj_cache:
            self._proj_cache[m] = self._tally_program(
                lower_serve_step(self.ops, m=m, seed=self.seed), m)
        parts = [self._proj_cache[m]]
        rows = m // len(contexts) if contexts else m
        for t in contexts:
            akey = (rows, t)
            if akey not in self._attn_cache:
                self._attn_cache[akey] = self._tally_program(
                    self._attention_program(rows, t), rows)
            parts.append(self._attn_cache[akey])
        tally = StepTally(m=0)
        for part in parts:
            tally.merge(part)
        tally.m = m
        self._step_cache[key] = tally
        return tally

    def step_pipeline(
        self, m: int, contexts: Sequence[int] = (),
    ) -> Tuple[int, int]:
        """One step's engine-view ``(serial, overlapped)`` cycles — the
        merged batch graph scheduled through the pipelined model, scaled
        to all model layers.

        The serial side equals :meth:`step_tally`'s ``cycles`` exactly
        (both sum the same per-stage round criticals); the overlapped
        side is what the batch actually costs when dependency-independent
        rounds — different slots' attention, the split projections —
        interleave (``repro_torch.legion.program.compute_pipeline``).  Composed
        from the cached sub-program executions: nothing re-executes, the
        merged graph only re-*schedules* the measured rounds.
        """
        contexts = self._ctx(tuple(contexts))
        key = (m, contexts)
        cached = self._pipeline_cache.get(key)
        if cached is None:
            self.step_tally(m, contexts)       # populate the round caches
            # skeleton graph: same names/workloads/levels/ancestry as the
            # executable step program, but no synthesized operand arrays —
            # this runs on the per-decode-step hot path
            program = lower_serve_step(
                self.ops, m=m, contexts=contexts, heads=self.heads,
                kv_heads=self.kv_heads, head_dim=self.head_dim,
                layers=self.layers, seed=self.seed, operands=False,
                page_tokens=self.page_tokens,
            )
            rounds = merge_round_criticals(
                {st.name: self._rounds[
                    (st.workload.stage, st.workload.m, st.workload.k,
                     st.workload.n, st.workload.count)]}
                for st in program
            )
            pp = compute_pipeline(program, rounds)
            if not pp.ok:
                raise AssertionError(
                    f"engine-view pipeline broke overlapped <= serial: {pp}"
                )
            cached = (pp.serial_cycles * self.layers,
                      pp.overlapped_cycles * self.layers)
            self._pipeline_cache[key] = cached
        return cached

    def step_pipeline_mixed(
        self, chunks: Sequence[Tuple[int, int]], *, decode_m: int = 0,
        decode_contexts: Sequence[int] = (),
    ) -> Tuple[int, int]:
        """One *mixed* (in-flight) step's engine-view ``(serial,
        overlapped)`` cycles: every prefill chunk's subgraph merged with
        the batched decode graph and scheduled as one pipelined step.

        ``chunks`` are ``(rows, context)`` shapes (context = chunk offset
        + rows); ``decode_contexts`` the decode slots' context tuple
        (``decode_m`` defaults to its length).  Like
        :meth:`step_pipeline`, nothing re-executes: the part-wise
        ``step_tally`` calls populate the per-shape round caches and the
        merged skeleton graph (``lower_serve_mixed(..., operands=False)``)
        only re-schedules them.  The serial side equals the sum of the
        parts' tallied cycles; the overlapped side is the step's actual
        latency once chunk rounds interleave with decode rounds.
        """
        chunks = tuple((int(r), int(t)) for r, t in chunks)
        decode_contexts = tuple(int(t) for t in decode_contexts)
        if decode_m == 0:
            decode_m = len(decode_contexts)
        if not chunks:
            return (self.step_pipeline(decode_m, decode_contexts)
                    if decode_m else (0, 0))
        key = (chunks, decode_m, decode_contexts, self.attention)
        cached = self._mixed_cache.get(key)
        if cached is None:
            for rows, t in chunks:           # populate the round caches
                self.step_tally(rows, (t,))
            if decode_m:
                self.step_tally(decode_m, decode_contexts)
            if self.attention:
                program = lower_serve_mixed(
                    self.ops, chunks=chunks,
                    decode_contexts=decode_contexts if decode_m else (),
                    heads=self.heads, kv_heads=self.kv_heads,
                    head_dim=self.head_dim, layers=self.layers,
                    seed=self.seed, operands=False,
                    page_tokens=self.page_tokens,
                )
            else:
                parts = [lower_serve_step(self.ops, m=rows, seed=self.seed,
                                          operands=False)
                         for rows, _t in chunks]
                tags = [f"{{p{i}}}" for i in range(len(parts))]
                if decode_m:
                    parts.append(lower_serve_step(
                        self.ops, m=decode_m, seed=self.seed,
                        operands=False))
                    tags.append("{d}")
                program = Program.merge(parts, tags=tags)
                program.validate()
            rounds = merge_round_criticals(
                {st.name: self._rounds[
                    (st.workload.stage, st.workload.m, st.workload.k,
                     st.workload.n, st.workload.count)]}
                for st in program
            )
            pp = compute_pipeline(program, rounds)
            if not pp.ok:
                raise AssertionError(
                    f"mixed-step pipeline broke overlapped <= serial: {pp}"
                )
            cached = (pp.serial_cycles * self.layers,
                      pp.overlapped_cycles * self.layers)
            self._mixed_cache[key] = cached
        return cached

    def step_program_mixed(
        self, chunks: Sequence[Tuple[int, int]],
        decode_contexts: Sequence[int] = (),
    ) -> Program:
        """The *executable* merged mixed-phase Program (operands
        synthesized) — what a :class:`~repro_torch.legion.machine
        .PipelinedExecutor` runs and a TimelineTracer measures; its
        skeleton twin is what :meth:`step_pipeline_mixed` schedules."""
        return lower_serve_mixed(
            self.ops, chunks=tuple(chunks),
            decode_contexts=tuple(decode_contexts), heads=self.heads,
            kv_heads=self.kv_heads, head_dim=self.head_dim,
            layers=self.layers, seed=self.seed,
            page_tokens=self.page_tokens,
        )

    def mixed_step_tally(
        self, chunks: Sequence[Tuple[int, int]],
        decode_contexts: Sequence[int] = (),
    ) -> StepTally:
        """Measured totals of one mixed step: the part tallies merged —
        byte/cycle identical to executing the merged graph itself."""
        tally = StepTally(m=0)
        for rows, t in chunks:
            tally.merge(self.step_tally(rows, self._ctx((t,))))
        decode_contexts = tuple(decode_contexts)
        if decode_contexts:
            tally.merge(self.step_tally(len(decode_contexts),
                                        self._ctx(decode_contexts)))
        return tally

    def mixed_workloads(
        self, chunks: Sequence[Tuple[int, int]],
        decode_contexts: Sequence[int] = (),
    ) -> List[GEMMWorkload]:
        """Analytic workload list of one mixed step (chunk parts then the
        decode part) — what :meth:`cross_validate_mixed` simulates."""
        out: List[GEMMWorkload] = []
        for rows, t in chunks:
            out.extend(self.workloads(rows, (t,)))
        decode_contexts = tuple(decode_contexts)
        if decode_contexts:
            out.extend(self.workloads(len(decode_contexts),
                                      decode_contexts))
        return out

    def cross_validate_mixed(
        self, chunks: Sequence[Tuple[int, int]],
        decode_contexts: Sequence[int] = (), *, rtol: float = 0.05,
    ) -> Tuple[List[StageValidation], List[CycleValidation]]:
        """:meth:`cross_validate` for a mixed prefill+decode step graph:
        measured per-stage tallies of the merged step vs ``simulate()``
        on the same concatenated workload list (``simulate`` aggregates
        by stage family, so both sides sum chunk and decode parts)."""
        chunks = tuple((int(r), int(t)) for r, t in chunks)
        tally = self.mixed_step_tally(chunks, decode_contexts)
        report = simulate(self.cfg,
                          self.mixed_workloads(chunks, decode_contexts))
        traffic_vals: List[StageValidation] = []
        cycle_vals: List[CycleValidation] = []
        for stage, st in tally.stages.items():
            sim = report.stages[stage]
            traffic_vals.append(StageValidation(
                stage=stage, measured=st.traffic,
                analytic=TrafficTotals(
                    weight_bytes=sim.weight_bytes, act_bytes=sim.act_bytes,
                    psum_bytes=sim.psum_bytes,
                    page_fetches=sim.page_fetches,
                    page_bytes=sim.page_bytes,
                    page_waste_bytes=sim.page_waste_bytes,
                ),
                rtol=rtol,
            ))
            cycle_vals.append(CycleValidation(
                stage=stage, measured=st.cycles, analytic=sim.cycles,
                rtol=rtol, analytic_breakdown=sim.cycle_breakdown,
            ))
        return traffic_vals, cycle_vals

    # ------------------------------------------------------------------ #
    def cross_validate(
        self, m: int = 1, *, contexts: Optional[Sequence[int]] = None,
        rtol: float = 0.05,
    ) -> Tuple[List[StageValidation], List[CycleValidation]]:
        """Compare a step's measured tallies against ``simulate()`` on the
        same extracted workloads — the serve-path falsifiability check,
        now covering the act-to-act attention stages too.

        Default ``contexts`` is prefill-shaped (``(m,)``: one slot
        attending over its own rows); pass e.g. ``contexts=(64,)`` with
        ``m=1`` for a decode step at context length 64.
        """
        if contexts is None:
            contexts = (m,)
        contexts = self._ctx(tuple(contexts))
        tally = self.step_tally(m, contexts)
        report = simulate(self.cfg, self.workloads(m, contexts))
        traffic_vals: List[StageValidation] = []
        cycle_vals: List[CycleValidation] = []
        for stage, st in tally.stages.items():
            sim = report.stages[stage]
            traffic_vals.append(StageValidation(
                stage=stage, measured=st.traffic,
                analytic=TrafficTotals(
                    weight_bytes=sim.weight_bytes, act_bytes=sim.act_bytes,
                    psum_bytes=sim.psum_bytes,
                    page_fetches=sim.page_fetches,
                    page_bytes=sim.page_bytes,
                    page_waste_bytes=sim.page_waste_bytes,
                ),
                rtol=rtol,
            ))
            cycle_vals.append(CycleValidation(
                stage=stage, measured=st.cycles, analytic=sim.cycles,
                rtol=rtol, analytic_breakdown=sim.cycle_breakdown,
            ))
        return traffic_vals, cycle_vals

    # ------------------------------------------------------------------ #
    def cache_budget(
        self, *, batch: int, max_seq: int, hbm_bytes_per_chip: float,
        chips: int, dtype_bytes: int = 2,
        page_tokens: Optional[int] = None,
    ):
        """Latency-aware KV budget from the *measured* serve path.

        The engine-view overlapped per-token cycles (what a pipelined
        batch actually sustains) set the budget's tokens/sec; the serial
        per-token cycles ride along so the
        :class:`~repro_torch.serve.kv_cache.CacheBudget` carries the pipelining
        speedup.  Needs at least one observed decode step.

        ``page_tokens`` defaults to the backend's own page size (paged
        backends plan page-granular capacity; contiguous ones don't);
        pass explicitly to override.
        """
        from repro_torch.serve.kv_cache import plan as kv_plan

        if page_tokens is None:
            page_tokens = self.page_tokens or None

        s = self.summary()
        overlapped = s["overlapped_cycles_per_decode_token"]
        if not overlapped:
            raise ValueError(
                "cache_budget needs measured decode steps; attach the "
                "backend to an engine and decode first"
            )
        serial = s["serial_cycles_per_decode_token"] or None
        budget = kv_plan(
            self.model_cfg, batch=batch, max_seq=max_seq,
            hbm_bytes_per_chip=hbm_bytes_per_chip, chips=chips,
            dtype_bytes=dtype_bytes, cycles_per_token=overlapped,
            freq_hz=self.cfg.freq_hz, serial_cycles_per_token=serial,
            page_tokens=page_tokens,
        )
        if self.metrics is not None:
            m = self.metrics
            m.gauge("kv_cache_utilization").set(
                budget.total_bytes / (hbm_bytes_per_chip * chips))
            if budget.tokens_per_sec:
                m.gauge("kv_tokens_per_sec").set(budget.tokens_per_sec)
            if budget.pipelining_speedup:
                m.gauge("kv_pipelining_speedup").set(
                    budget.pipelining_speedup)
        return budget

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        """Batch-accurate engine totals (``self.totals``) + request counts.

        ``cycles``/``*_bytes`` count each batched decode step once at its
        true batch size — the hardware-level total, smaller than the sum of
        the standalone per-request tallies whenever decode steps batched.
        ``cycles_per_decode_token`` is the mean *standalone* per-token cost
        over every decoded token (position-dependent attention included).

        The engine view rides alongside: every batched decode step also
        runs as one merged batch graph through the pipelined schedule, so
        ``overlapped_cycles_per_step`` <= ``serial_cycles_per_step``
        (asserted per step) is the step latency with per-slot attention
        rounds interleaved, and ``overlapped_cycles_per_decode_token`` is
        the number to feed — with ``AcceleratorConfig.freq_hz`` — into
        ``repro_torch.serve.kv_cache.plan`` (or just call :meth:`cache_budget`)
        for the tokens/sec the fleet actually sustains.
        """
        reqs = self.per_request.values()
        decode_tokens = sum(r.decode_tokens for r in reqs)
        decode_cycles = (self._decode_cycles / self._decode_tokens
                         if self._decode_tokens else 0.0)
        # per-step numbers average over the engine-view steps (== decode
        # steps in legacy mode; in-flight mixed steps count once each and
        # carry prefill too); per-token numbers stay decode-only so the
        # cache_budget rate never absorbs prefill cycles
        steps = self.engine_steps
        serial_step = self._engine_serial_cycles / steps if steps else 0.0
        overlap_step = (self._engine_overlapped_cycles / steps
                        if steps else 0.0)
        overlap_token = (self._decode_overlapped_cycles / self._decode_tokens
                         if self._decode_tokens else 0.0)
        serial_token = (self._decode_serial_cycles / self._decode_tokens
                        if self._decode_tokens else 0.0)
        return {
            "requests": len(self.per_request),
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "engine_steps": self.engine_steps,
            "prefill_tokens": sum(r.prefill_tokens for r in reqs),
            "decode_tokens": decode_tokens,
            "weight_bytes": self.totals.weight_bytes,
            "act_bytes": self.totals.act_bytes,
            "psum_bytes": self.totals.psum_bytes,
            # paged-KV pricing (zero for contiguous backends): distinct
            # page fetches, whole-page bytes, and the padding share of
            # them (waste is also inside weight_bytes — the delta vs a
            # contiguous backend on the same trace)
            "page_fetches": self.totals.page_fetches,
            "page_fetch_bytes": self.totals.page_bytes,
            "page_waste_bytes": self.totals.page_waste_bytes,
            "page_waste_frac": (
                self.totals.page_waste_bytes / self.totals.page_bytes
                if self.totals.page_bytes else 0.0),
            "cycles": self.totals.cycles,
            # finite-bandwidth serving: the exposed weight-prefetch share
            # of every step's cycles (0 at the default infinite mem_bw)
            "stall_cycles": self.totals.stall_cycles,
            "stall_frac": self.totals.stall_frac,
            "cycles_per_decode_token": decode_cycles,
            "us_per_decode_token": decode_cycles / self.cfg.freq_hz * 1e6,
            # engine view: the merged batch graph, pipelined
            "serial_cycles_per_step": serial_step,
            "overlapped_cycles_per_step": overlap_step,
            "serial_cycles_per_decode_token": serial_token,
            "overlapped_cycles_per_decode_token": overlap_token,
            "pipeline_speedup": (serial_step / overlap_step
                                 if overlap_step else 1.0),
            "overlapped_us_per_decode_token":
                overlap_token / self.cfg.freq_hz * 1e6,
        }
