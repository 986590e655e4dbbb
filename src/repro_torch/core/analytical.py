"""Analytical model of D-Legion — paper eqs. (1)-(3) + DSE metrics (SS III).

All formulas operate on a single GEMM workload of dimensions (M, K, N):
``out[M, N] = act[M, K] @ weight[K, N]`` with the *weight* matrix stationary.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.config import AcceleratorConfig, Dataflow


@dataclasses.dataclass(frozen=True)
class Tiles:
    """Matrix tiling (paper eq. 1)."""

    mt: int  # ceil(M / D)
    kt: int  # ceil(K / (C * D))   — K split across the C cores of a Legion
    nt: int  # ceil(N / (R * D))   — R interleaved weight tiles along N


def tiles(m: int, k: int, n: int, *, d: int, c: int = 1, r: int = 1) -> Tiles:
    return Tiles(
        mt=math.ceil(m / d),
        kt=math.ceil(k / (c * d)),
        nt=math.ceil(n / (r * d)),
    )


def tile_pass_cycles(cfg: AcceleratorConfig, mt: int) -> int:
    """Cycles for one (KT, NT) tile pass, by dataflow family.

    WS pays sync-FIFO fill/drain (one extra D per pass); DiP eliminates it;
    ADiP adds P pipeline stages for the shared shifters/accumulators.
    """
    d = cfg.d
    if cfg.dataflow is Dataflow.WS:
        return d * (mt + 2)
    if cfg.dataflow is Dataflow.DIP:
        return d * (mt + 1)
    return d * (mt + 1) + cfg.pipeline  # ADiP / D-Legion cores


@dataclasses.dataclass(frozen=True)
class PassBreakdown:
    """Where one tile pass's cycles go, plus the per-work-chunk drain.

    The single source of the decomposition both the analytic simulator
    (``StageResult.cycle_breakdown``) and the legion runtime's counted
    cycles (``repro_torch.legion.latency.CycleCounter``) report — keeping the two
    sides of the cycle cross-validation comparable term by term.
    ``stream + fill + pipeline == tile_pass_cycles(cfg, mt)``.
    """

    stream: int    # MT row-tiles of D cycles streaming through the array
    fill: int      # systolic fill (the "+1" D; WS sync-FIFOs pay 2D)
    pipeline: int  # ADiP shared shifter/accumulator stages (P)
    drain: int     # output drain per (unit, round) work chunk


def pass_cycle_breakdown(cfg: AcceleratorConfig, mt: int) -> PassBreakdown:
    stream = cfg.d * mt
    pipeline = cfg.pipeline if cfg.dataflow is Dataflow.ADIP else 0
    return PassBreakdown(
        stream=stream,
        fill=tile_pass_cycles(cfg, mt) - stream - pipeline,
        pipeline=pipeline,
        drain=2 * cfg.d if cfg.dataflow is Dataflow.WS else cfg.d,
    )


def unit_latency_cycles(
    cfg: AcceleratorConfig, m: int, k: int, n: int, weight_bits: int = 8,
    *, skipped_kt: int = 0,
) -> int:
    """End-to-end latency of one GEMM on one unit (Legion) — paper eq. (2):

        Latency_Legion = KT * NT * (D * (MT + 1) + P) + D

    generalized across dataflows via :func:`tile_pass_cycles`.  ``skipped_kt``
    subtracts fully-sparse ZTB windows (each window covers one KT step).
    """
    r = cfg.r(weight_bits)
    t = tiles(m, k, n, d=cfg.d, c=cfg.cores, r=r)
    kt_eff = max(t.kt - skipped_kt, 0)
    drain = pass_cycle_breakdown(cfg, t.mt).drain
    return kt_eff * t.nt * tile_pass_cycles(cfg, t.mt) + drain


def tfu_cycles(cfg: AcceleratorConfig) -> int:
    """Time-to-full-utilization (paper eq. 3): TFU = D."""
    return cfg.d


def boundary_overlap_cycles(
    prev_stream: int, next_fill: int, next_pipeline: int,
    *, prev_drain: int = 0,
) -> int:
    """Cycles hidden at a round boundary between DEPENDENCY-INDEPENDENT
    rounds: the incoming round's systolic fill + pipeline ramp proceeds
    under the outgoing round's activation streaming — and, when given,
    its output drain (the array's input side is idle while results drain,
    so an unrelated round's stationary tiles can fill meanwhile; the same
    double-buffering that hides weight prefetch — ADiP's shared
    shifter/accumulator pipeline keeps the array busy while the next tile
    set fills).  Bounded by the outgoing stream + drain so the overlapped
    schedule can never beat the work actually streamed; rounds with a
    data dependency overlap nothing (the incoming operands do not exist
    yet).

    The single source of the pipelined-executor timing rule
    (``repro_torch.legion.program.compute_pipeline``).
    """
    return max(0, min(next_fill + next_pipeline, prev_stream + prev_drain))


def weight_prefetch_overlap_cycles(
    prev_stream: int, next_fill: int, *, prev_drain: int = 0,
) -> int:
    """Cycles hidden at a round boundary between DATA-DEPENDENT rounds
    whose incoming *stationary* operand is independent of the outgoing
    stage: the stationary tiles (weights, or a K-V cache produced earlier)
    already exist in memory, so their systolic fill proceeds into the
    double buffer while the outgoing round is still streaming (and
    draining) the very rows the incoming round will consume.  Only the
    fill hides — the pipeline ramp is coupled to the streamed input,
    which does not exist until the outgoing round finishes.  Boundaries
    whose stationary operand is itself produced by the outgoing stage
    (attention's S = Q.K^T consuming the just-written K) hide nothing.

    The cross-level half of the pipelined-executor timing rule
    (``repro_torch.legion.program.compute_pipeline``); sibling of
    :func:`boundary_overlap_cycles`, which handles the
    dependency-independent case where fill + pipeline both hide.
    """
    return max(0, min(next_fill, prev_stream + prev_drain))


# --------------------------------------------------------------------------- #
# DSE metrics (paper SS III, Figs. 2-4)
# --------------------------------------------------------------------------- #

def unit_input_bandwidth(cfg: AcceleratorConfig) -> int:
    """Streamed-input bytes/cycle into one Legion: one int8 row element per
    core column group => C * D."""
    return cfg.cores * cfg.d


def accumulator_bandwidth(cfg: AcceleratorConfig, r: int = 1) -> int:
    """Bytes/cycle entering the Legion accumulators: each of C cores emits an
    R*D-wide int32 psum stream (paper SS IV-A.2)."""
    return cfg.cores * r * cfg.d * 4


def psum_memory_bandwidth(cfg: AcceleratorConfig, r: int = 1) -> int:
    """Bytes/cycle written to psum banks *after* spatial reduction: a single
    R*D-wide int32 stream — C x lower than without Legion accumulators."""
    return r * cfg.d * 4


def mean_latency(
    cfg: AcceleratorConfig, workloads, weight_bits_default: int = 8
) -> float:
    tot = 0.0
    for w in workloads:
        tot += unit_latency_cycles(cfg, w.m, w.k, w.n, w.weight_bits)
    return tot / max(len(list(workloads)), 1)


def cri(
    cfg: AcceleratorConfig,
    workloads,
    *,
    reference_latency: float | None = None,
) -> float:
    """Configuration Rate Index (paper Fig. 4).

    The paper introduces CRI as a figure of merit combining Legion input
    bandwidth, TFU, and mean corner-case workload latency (lower of each is
    better).  The exact closed form is not given; we use the natural
    product-of-normalized-inverses

        CRI = 1e12 / (input_bw * TFU * mean_latency)

    which ranks 8x(16x16) above 2x(64x64) and 4x(32x32), matching the
    paper's selection (SS III-B).
    """
    lat = mean_latency(cfg, workloads)
    if reference_latency:
        lat = lat / reference_latency
    bw = unit_input_bandwidth(cfg)
    return 1e12 / (bw * tfu_cycles(cfg) * lat)


def hbm_legions_supported(
    *, stack_bw_gbs: float = 512.0, stacks: int = 16,
    legion_bw_gbs: float = 128.0,
) -> int:
    """Scaling bound from HBM3 (paper SS V-B): each Legion needs a 1024-bit
    @ 1 GHz = 128 GB/s interface; 16 stacks x 512 GB/s => 64 Legions."""
    return int(stacks * stack_bw_gbs // legion_bw_gbs)
