"""Legion scheduler — the D-Legion orchestrator's workload mapping (SS IV-C).

Produces explicit, testable assignment plans:

* MHA/GQA projection workloads: one head workload per Legion, round-robin.
* Activation-to-activation workloads: each head's GEMM is N-partitioned
  across all Legions; heads iterate; KV stationary tiles are multicast to
  the Legions serving heads of the same GQA group.
* Output projection: single GEMM N-partitioned across all Legions.

The same plan objects drive the cycle simulator's mapping policy and are
mirrored by the sharding rules of ``repro_torch.distributed.sharding``
(heads over the ``model`` mesh axis ≙ heads over Legions; KV replication
within a group ≙ KV multicast), whose ``legion_rules`` put a plan's Legion
axis on a mesh axis for ``legion.machine.ShardedExecutor``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.workloads import (
    GEMMWorkload,
    HEAD_PER_UNIT,
    N_PARTITION,
)


@dataclasses.dataclass(frozen=True)
class Assignment:
    """One unit of work placed on one Legion in one round.

    ``k_tiles``/``k_window`` make the psum accumulation explicit: the
    assignment's GEMM executes as ``k_tiles`` K-windows of ``k_window``
    elements (one window = the C cores' K-split, spatially reduced by the
    Legion accumulators), so a runtime performs exactly ``k_tiles`` psum
    rounds — the first write-only, the rest read-modify-write.
    """

    legion: int
    round: int
    instance: int            # which head / workload instance
    n_lo: int                # N-slice [n_lo, n_hi) of the instance's GEMM
    n_hi: int
    multicast_group: int     # Legions sharing stationary tiles (KV group id)
    k_tiles: int = 1         # KT = ceil(K / (C*D)) psum accumulation rounds
    k_window: int = 0        # K elements per round (C*D); 0 = un-annotated


@dataclasses.dataclass(frozen=True)
class StagePlan:
    stage: str
    mapping: str
    assignments: List[Assignment]
    rounds: int
    weight_bits: int = 8     # stationary-operand precision (mode selection)
    # Paged-KV geometry copied from the workload (see GEMMWorkload): the
    # stationary operand is block-allocated in page_tokens-token pages
    # along page_axis; 0 / "" = contiguous.
    page_tokens: int = 0
    page_axis: str = ""

    def legions_used(self) -> int:
        return len({a.legion for a in self.assignments})

    def instances_covered(self) -> Dict[int, int]:
        """instance -> number of (legion, round) cells covering it."""
        out: Dict[int, int] = {}
        for a in self.assignments:
            out[a.instance] = out.get(a.instance, 0) + 1
        return out


def plan_stage(
    cfg: AcceleratorConfig, w: GEMMWorkload, *, stage: Optional[str] = None,
) -> StagePlan:
    """Map one workload onto the Legion grid.

    ``stage`` overrides the plan's stage label (defaults to ``w.stage``) —
    program graphs use it to give each node a unique name (e.g. per-slot
    decode attention stages ``attn_score[j]``) so instrument event streams
    and cycle cells stay distinguishable per node.

    ``cfg.mapping_override`` forces the mapping policy regardless of the
    workload's preference (TPUv4i N-partitions every GEMM across its
    MXUs) — the same rule the analytic ``simulate()`` applies, so executed
    plans and analytic results stay comparable on such configs.
    """
    L = cfg.units
    mapping = cfg.mapping_override or w.mapping
    k_window = cfg.cores * cfg.d
    k_tiles = max(math.ceil(w.k / k_window), 1)
    assignments: List[Assignment] = []
    if mapping == HEAD_PER_UNIT and L > 1:
        rounds = math.ceil(w.count / L)
        for inst in range(w.count):
            rnd, leg = divmod(inst, L)
            assignments.append(Assignment(
                legion=leg, round=rnd, instance=inst, n_lo=0, n_hi=w.n,
                multicast_group=inst // max(w.kv_group, 1),
                k_tiles=k_tiles, k_window=k_window,
            ))
    else:
        # N-partition: every Legion takes an N-slice; instances iterate.
        n_slice = math.ceil(w.n / L)
        rounds = w.count
        for inst in range(w.count):
            group = inst // max(w.kv_group, 1)
            for leg in range(L):
                lo = leg * n_slice
                hi = min(lo + n_slice, w.n)
                if lo >= hi:
                    continue
                assignments.append(Assignment(
                    legion=leg, round=inst, instance=inst, n_lo=lo, n_hi=hi,
                    multicast_group=group,
                    k_tiles=k_tiles, k_window=k_window,
                ))
    return StagePlan(stage=stage or w.stage, mapping=mapping,
                     assignments=assignments, rounds=rounds,
                     weight_bits=w.weight_bits,
                     page_tokens=w.page_tokens, page_axis=w.page_axis)


def plan_model(
    cfg: AcceleratorConfig, workloads: Sequence[GEMMWorkload],
) -> List[StagePlan]:
    return [plan_stage(cfg, w) for w in workloads]


def kv_multicast_fanout(plan: StagePlan) -> Dict[int, int]:
    """multicast_group -> number of distinct (legion, round) consumers.

    For GQA act-to-act stages this is the paper's KV-reuse factor H/G x L
    N-slices; the NoC fetches the group's KV tiles from memory once.
    """
    out: Dict[int, int] = {}
    for a in plan.assignments:
        out[a.multicast_group] = out.get(a.multicast_group, 0) + 1
    return out
