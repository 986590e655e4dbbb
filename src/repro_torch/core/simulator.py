"""Cycle/traffic simulator for WS, DiP, ADiP, D-Legion and modeled TPUv4i.

Reproduces the paper's evaluation methodology (SS V): for each attention stage
workload it accounts

    latency (cycles)           eq. (2) + the stage mapping policy (SS IV-C)
    throughput (TOPS)          workload ops / latency
    memory access (GB)         stationary weights + streamed activations,
                               with NoC multicast reuse for D-Legion (SS IV-B)
    psum memory access (GB)    read-modify-write rounds: (2*KT - 1) * M*N*4B,
                               KT = ceil(K / (C*D)) — the Legion accumulators'
                               spatial reduction divides RMW rounds by C

Sparsity (ZTB, SS IV-A.4): fully-sparse windows skip KT steps (latency,
memory, and psum all shrink); partially-sparse windows only gate cores
(energy proxy, no latency change) — both accepted via ``ZTBStats``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional

from repro_torch.core.analytical import (
    pass_cycle_breakdown,
    tiles,
    unit_latency_cycles,
)
from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.sparsity import ZTBStats
from repro_torch.core.workloads import (
    GEMMWorkload,
    HEAD_PER_UNIT,
    N_PARTITION,
    STAGES,
)


@dataclasses.dataclass
class StageResult:
    stage: str
    cycles: int = 0
    ops: int = 0
    weight_bytes: float = 0.0
    act_bytes: float = 0.0
    psum_bytes: float = 0.0
    # Paged-KV accounting (zero unless the workload carries page_tokens):
    # distinct page fetches, whole-page bytes, and the last-page padding.
    # The waste is ALSO folded into ``weight_bytes`` — a page fetch moves
    # padding a contiguous layout never would.
    page_fetches: float = 0.0
    page_bytes: float = 0.0
    page_waste_bytes: float = 0.0
    # Cycle decomposition (sums to ``cycles``): activation rows streaming
    # through the array, systolic fill per tile pass, ADiP pipeline stages,
    # and the output drain per (unit, round) — comparable component-wise to
    # the legion runtime's counted cycles (repro_torch.legion.latency).
    stream_cycles: int = 0
    fill_cycles: int = 0
    pipeline_cycles: int = 0
    drain_cycles: int = 0
    # Exposed weight-prefetch cycles under a finite fetch bandwidth (zero at
    # the default infinite bandwidth) — included in ``cycles``.
    stall_cycles: int = 0

    @property
    def mem_bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    @property
    def cycle_breakdown(self) -> Dict[str, int]:
        return {
            "stream": self.stream_cycles,
            "fill": self.fill_cycles,
            "pipeline": self.pipeline_cycles,
            "drain": self.drain_cycles,
            "stall": self.stall_cycles,
        }

    def seconds(self, freq_hz: float) -> float:
        return self.cycles / freq_hz

    def tops(self, freq_hz: float) -> float:
        if self.cycles == 0:
            return 0.0
        return self.ops / self.seconds(freq_hz) / 1e12


@dataclasses.dataclass
class SimReport:
    arch: str
    freq_hz: float
    stages: Dict[str, StageResult]

    @property
    def total_cycles(self) -> int:
        return sum(s.cycles for s in self.stages.values())

    @property
    def total_seconds(self) -> float:
        return self.total_cycles / self.freq_hz

    @property
    def total_ops(self) -> int:
        return sum(s.ops for s in self.stages.values())

    @property
    def total_tops(self) -> float:
        return self.total_ops / self.total_seconds / 1e12

    @property
    def total_mem_gb(self) -> float:
        return sum(s.mem_bytes for s in self.stages.values()) / 1e9

    @property
    def total_psum_gb(self) -> float:
        return sum(s.psum_bytes for s in self.stages.values()) / 1e9


def _padded_k(cfg: AcceleratorConfig, k: int) -> int:
    t = math.ceil(k / (cfg.cores * cfg.d))
    return t * cfg.cores * cfg.d


def _simulate_workload(
    cfg: AcceleratorConfig,
    w: GEMMWorkload,
    ztb: Optional[ZTBStats] = None,
    mem_bw_bytes_per_cycle: float = math.inf,
) -> StageResult:
    res = StageResult(stage=w.stage, ops=w.ops)
    r = cfg.r(w.weight_bits)
    units = cfg.units
    wbytes = cfg.weight_bytes_per_element(w.weight_bits)
    k_pad = _padded_k(cfg, w.k)
    mapping = cfg.mapping_override or w.mapping

    # ---- effective per-unit GEMM shape under the mapping policy ---------- #
    if units > 1 and mapping == N_PARTITION:
        n_unit = math.ceil(w.n / units)
        rounds = w.count                       # iterate instances (heads)
        multicast_stream = True                # same act rows to all units
    elif units > 1:  # HEAD_PER_UNIT
        n_unit = w.n
        rounds = math.ceil(w.count / units)
        multicast_stream = w.shared_input      # same X to all Legions
    else:
        n_unit = w.n
        rounds = w.count
        multicast_stream = False

    t = tiles(w.m, w.k, n_unit, d=cfg.d, c=cfg.cores, r=r)

    # ---- ZTB sparsity: fully-sparse windows skip whole KT steps --------- #
    skipped_kt = 0
    if ztb is not None and ztb.fully_sparse_fraction > 0:
        skipped_kt = int(t.kt * ztb.fully_sparse_fraction)

    lat = unit_latency_cycles(
        cfg, w.m, w.k, n_unit, w.weight_bits, skipped_kt=skipped_kt
    )
    res.cycles = lat * rounds * w.layers
    kt_keep = (t.kt - skipped_kt) / t.kt if t.kt else 1.0

    # ---- cycle breakdown (mirrors eq. 2 term by term) --------------------- #
    passes = max(t.kt - skipped_kt, 0) * t.nt          # (KT, NT) tile passes
    per_pass = pass_cycle_breakdown(cfg, t.mt)
    scale = rounds * w.layers
    res.stream_cycles = passes * per_pass.stream * scale
    res.fill_cycles = passes * per_pass.fill * scale
    res.pipeline_cycles = passes * per_pass.pipeline * scale
    res.drain_cycles = per_pass.drain * scale

    # ---- exposed weight-prefetch stalls (finite fetch bandwidth) --------- #
    # Mirrors ``CycleCounter.record_assignment`` for the round-critical
    # Legion — the full-slice Legion under N-partition (the memory
    # controller clips its stationary fetches at the slice edge), any
    # Legion otherwise (padded R*D tiles) — including the measured model's
    # per-assignment ``int(round())`` and float evaluation order, so
    # cross-validation stays exact at 0%.
    if passes and mem_bw_bytes_per_cycle != math.inf:
        pass_c = per_pass.stream + per_pass.fill + per_pass.pipeline
        if mapping == N_PARTITION and units > 1:
            width_total = n_unit
        else:
            width_total = t.nt * r * cfg.d
        assign_bytes = (
            max(t.kt - skipped_kt, 0) * cfg.cores * cfg.d * width_total
            * wbytes
        )
        fetch = (assign_bytes / passes) / mem_bw_bytes_per_cycle
        res.stall_cycles = int(round(passes * max(0.0, fetch - pass_c))) \
            * scale
        res.cycles += res.stall_cycles

    # ---- stationary (weight / KV) traffic -------------------------------- #
    # Loaded once per tile; padded to full tile grid.  D-Legion multicasts
    # the stationary KV tiles across the kv_group query heads (SS IV-B).
    if mapping == N_PARTITION and units > 1:
        # the memory controller clips every Legion's fetch to the matrix
        # edge — memory only holds w.n columns, so even a matrix narrower
        # than one R*D tile (decode-shaped act-to-act stages, N = context)
        # moves w.n columns, not a padded tile
        n_pad_total = min(t.nt * r * cfg.d * units, w.n)
    else:
        n_pad_total = t.nt * r * cfg.d
    distinct = w.count / w.kv_group if (units > 1 and w.kv_group > 1) \
        else w.count
    res.weight_bytes = (
        k_pad * n_pad_total * wbytes * distinct * w.layers * kt_keep
    )

    # ---- paged-KV traffic (block-allocated stationary operand) ----------- #
    # The KV matrix is fetched in whole page_tokens-token pages along the
    # token axis; the last page carries padding tokens the contiguous
    # layout never moves.  Per-token footprint is the *unpadded* non-token
    # dimension (K elems per K^T column for attn_score, N elems per V row
    # for attn_output) — identical to the runtime's per-page accounting, so
    # cross-validation stays exact.  Paged stages are 8-bit (no kt_keep —
    # ZTB only applies to sub-8-bit weights, and pages are fetched whole).
    if w.page_tokens:
        per_tok = w.k if w.page_axis == "n" else w.n
        page_unit = per_tok * wbytes * distinct * w.layers
        res.page_fetches = w.page_count * distinct * w.layers
        res.page_bytes = w.page_count * w.page_tokens * page_unit
        res.page_waste_bytes = w.page_waste_tokens * page_unit
        res.weight_bytes += res.page_waste_bytes

    # ---- streamed (activation) traffic ----------------------------------- #
    # The input matrix re-streams once per N-tile pass; NoC multicast shares
    # one stream across Legions (SS IV-B "input broadcast", "8x reuse").
    stream_bytes_once = w.m * k_pad * cfg.dtype_bytes  # activations
    if multicast_stream:
        res.act_bytes = stream_bytes_once * t.nt * rounds * w.layers * kt_keep
    else:
        res.act_bytes = (
            stream_bytes_once * t.nt * rounds
            * (units if units > 1 and mapping == N_PARTITION else 1)
            * w.layers * kt_keep
        )

    # ---- psum traffic ----------------------------------------------------- #
    # KT accumulation rounds; first is write-only, the rest read-modify-write.
    # The full-skip limit (every window ZTB-gated — an unchosen MoE expert)
    # touches the accumulators zero times, matching the runtime's silence.
    kt_eff = max(t.kt - skipped_kt, 0)
    rmw = max(2 * kt_eff - 1, 0)
    res.psum_bytes = w.m * w.n * 4.0 * rmw * w.count * w.layers
    return res


def simulate_workload(
    cfg: AcceleratorConfig,
    w: GEMMWorkload,
    ztb: Optional[ZTBStats] = None,
    *,
    mem_bw_bytes_per_cycle: float = math.inf,
) -> StageResult:
    """Analytic result of ONE workload, without stage-name aggregation.

    The per-node counterpart ``Machine.run`` validates measured traffic and
    cycles against: a program may contain several nodes whose workloads
    share a stage name (e.g. per-slot decode attention), so validation
    needs the single-workload result, not ``simulate()``'s per-stage sum.
    ZTB applies to sub-8-bit weight stages only, exactly as in
    :func:`simulate`.  A finite ``mem_bw_bytes_per_cycle`` adds the
    exposed weight-prefetch stalls a ``CycleCounter`` at that bandwidth
    counts (``stall_cycles``, included in ``cycles``).
    """
    return _simulate_workload(
        cfg, w, ztb if w.weight_bits < 8 else None,
        mem_bw_bytes_per_cycle=mem_bw_bytes_per_cycle,
    )


def simulate(
    cfg: AcceleratorConfig,
    workloads: Iterable[GEMMWorkload],
    ztb: Optional[ZTBStats] = None,
    *,
    mem_bw_bytes_per_cycle: float = math.inf,
) -> SimReport:
    stages: Dict[str, StageResult] = {}
    for w in workloads:
        r = simulate_workload(  # ZTB is on sub-8-bit weights
            cfg, w, ztb, mem_bw_bytes_per_cycle=mem_bw_bytes_per_cycle)

        agg = stages.setdefault(w.stage, StageResult(stage=w.stage))
        agg.cycles += r.cycles
        agg.ops += r.ops
        agg.weight_bytes += r.weight_bytes
        agg.act_bytes += r.act_bytes
        agg.psum_bytes += r.psum_bytes
        agg.page_fetches += r.page_fetches
        agg.page_bytes += r.page_bytes
        agg.page_waste_bytes += r.page_waste_bytes
        agg.stream_cycles += r.stream_cycles
        agg.fill_cycles += r.fill_cycles
        agg.pipeline_cycles += r.pipeline_cycles
        agg.drain_cycles += r.drain_cycles
        agg.stall_cycles += r.stall_cycles
    return SimReport(arch=cfg.name, freq_hz=cfg.freq_hz, stages=stages)


def compare(
    reports: List[SimReport], baseline: str,
) -> Dict[str, Dict[str, float]]:
    """Ratios of ``baseline`` over each report (a ratio > 1 means the report's
    architecture improves on the baseline — the paper's 'up to Nx' style)."""
    base = next(r for r in reports if r.arch == baseline)
    out: Dict[str, Dict[str, float]] = {}
    for rep in reports:
        row = {
            "latency_x": base.total_seconds / rep.total_seconds,
            "throughput_x": rep.total_tops / base.total_tops,
            "mem_x": base.total_mem_gb / max(rep.total_mem_gb, 1e-30),
            "psum_x": base.total_psum_gb / max(rep.total_psum_gb, 1e-30),
        }
        for st in STAGES:
            if st in rep.stages and st in base.stages:
                row[f"latency_x[{st}]"] = (
                    base.stages[st].cycles / max(rep.stages[st].cycles, 1)
                )
        out[rep.arch] = row
    return out
