"""Legion runtime — plan validation and operand synthesis.

The numerical execution of scheduler StagePlans (SS IV-B/C) lives behind
the :class:`~repro_torch.legion.machine.Machine` session facade: operand
preparation and the psum-accumulator window loop are in
``repro_torch.legion.machine`` (shared by every :class:`ExecutorBackend`), and
measurement is pluggable via the :class:`Instrument` protocol.

This module keeps the pieces that are not session state:

* :func:`validate_coverage` — a plan must tile each instance's N-range
  exactly once (gaps/overlaps are hard errors);
* :func:`synthesize_operands` — reproducible int8 operands per workload.

The ``execute_plan``/``execute_workload`` shims that once lived here
(deprecated in PR 3) were removed in PR 6; ``Machine(cfg).run(...)`` is
the only entry point.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.scheduler import StagePlan
from repro_torch.core.sparsity import ZeroTileBook, ZTBStats, ztb_from_weight
from repro_torch.core.workloads import GEMMWorkload
from repro_torch.legion.modes import ModeSpec


class PlanCoverageError(ValueError):
    """A StagePlan's assignments do not exactly tile an instance's N-range."""


def validate_coverage(
    plan: StagePlan, *, n: Optional[int] = None, count: Optional[int] = None,
) -> Dict[int, List[Tuple[int, int]]]:
    """Check every instance's N-range [0, n) is tiled exactly once.

    Returns instance -> sorted (n_lo, n_hi) slices.  Raises
    :class:`PlanCoverageError` on gaps, overlaps, or missing instances.
    """
    slices: Dict[int, List[Tuple[int, int]]] = {}
    for a in plan.assignments:
        slices.setdefault(a.instance, []).append((a.n_lo, a.n_hi))
    if count is not None and set(slices) != set(range(count)):
        raise PlanCoverageError(
            f"instances covered {sorted(slices)} != 0..{count - 1}"
        )
    for inst, ss in slices.items():
        ss.sort()
        full_n = n if n is not None else ss[-1][1]
        if ss[0][0] != 0 or ss[-1][1] != full_n:
            raise PlanCoverageError(
                f"instance {inst}: slices span [{ss[0][0]}, {ss[-1][1]}) "
                f"!= [0, {full_n})"
            )
        for (l1, h1), (l2, h2) in zip(ss, ss[1:]):
            if h1 != l2:
                raise PlanCoverageError(
                    f"instance {inst}: slice [{l1},{h1}) then [{l2},{h2}) "
                    f"({'overlap' if h1 > l2 else 'gap'})"
                )
    return slices


# --------------------------------------------------------------------------- #
# Operand helpers (shared with repro_torch.legion.machine)
# --------------------------------------------------------------------------- #

def _instance_view(arr: np.ndarray, inst: int, ndim: int) -> np.ndarray:
    return arr if arr.ndim == ndim else arr[inst]

def _pad_axis(arr: np.ndarray, axis: int, target: int) -> np.ndarray:
    if arr.shape[axis] == target:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, pad)


def _build_books(
    w: np.ndarray, count: int, cfg: AcceleratorConfig, mode: ModeSpec,
) -> List[ZeroTileBook]:
    """Offline ZTB build, one book per instance, aligned with the runtime's
    window (C tiles of D rows) / N-tile (R*D columns) geometry."""
    return [
        ztb_from_weight(
            np.asarray(_instance_view(w, i, 2)),
            block_k=cfg.d, block_n=mode.n_tile(cfg.d), window=cfg.cores,
        )
        for i in range(count)
    ]


def combined_ztb_stats(books: Sequence[ZeroTileBook]) -> ZTBStats:
    stats = [b.stats() for b in books]
    nw = sum(s.num_windows for s in stats)
    nt = sum(s.num_tiles for s in stats)
    return ZTBStats(
        fully_sparse_fraction=(
            sum(s.fully_sparse_fraction * s.num_windows for s in stats) / nw
            if nw else 0.0
        ),
        zero_tile_fraction=(
            sum(s.zero_tile_fraction * s.num_tiles for s in stats) / nt
            if nt else 0.0
        ),
        num_windows=nw,
        num_tiles=nt,
    )


# --------------------------------------------------------------------------- #
# Workload-level operand synthesis
# --------------------------------------------------------------------------- #

def synthesize_operands(
    w: GEMMWorkload, *, seed: int = 0, ztb_sparsity: float = 0.0,
    k_window: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Small-magnitude int8 operands for one workload.

    Activations are shared ([M, K]) iff the workload streams one input to
    every instance; weights are ternary for 2-bit stages.  With
    ``ztb_sparsity`` a fraction of whole K-windows is zeroed across all
    instances — block-structured sparsity with *uniform* fully-sparse
    windows, so the simulator's global-fraction model matches exactly.
    """
    rng = np.random.default_rng(seed)
    xshape = (w.m, w.k) if w.shared_input else (w.count, w.m, w.k)
    x = rng.integers(-8, 9, size=xshape).astype(np.int8)
    # KV-group instances share their stationary matrix (the data behind the
    # paper's KV multicast) — generate one matrix per group and replicate.
    groups = math.ceil(w.count / max(w.kv_group, 1))
    # value range must be representable at the workload's precision
    # (ternary for W1.58; [-8, 7] for 4-bit two's complement)
    lohi = {2: (-1, 2), 4: (-8, 8)}.get(w.weight_bits, (-8, 9))
    per_group = rng.integers(*lohi, size=(groups, w.k, w.n)).astype(np.int8)
    weights = per_group[
        np.arange(w.count) // max(w.kv_group, 1)
    ].copy()
    if ztb_sparsity > 0.0:
        if not k_window:
            raise ValueError("ztb_sparsity needs the plan's k_window")
        k_tiles = math.ceil(w.k / k_window)
        n_zero = int(k_tiles * ztb_sparsity)
        zeroed = rng.choice(k_tiles, size=n_zero, replace=False)
        for i in zeroed:
            weights[:, i * k_window:(i + 1) * k_window, :] = 0
    return x, weights
