"""Adaptive-precision mode selection — the runtime half of paper SS IV-A.

An :class:`AcceleratorConfig` already knows the replication factor
``R = 8 / weight_bits`` (``cfg.r``); this module turns that into a complete
execution mode: which kernel backend runs a StagePlan's tiles, whether the
stationary operand travels packed sub-byte, and how wide an N-tile the
Legion accumulators emit per pass (``R * D``).

Mode matrix (BitNet attention workloads, paper SS V):

    name     weight_bits  R (adaptive)  backend        stationary operand
    W1.58    2            4             bitlinear      ternary, packed 4/B
    W4       4            2             bitlinear      int4, packed 2/B
    W8       8            1             dense          int8 dense
    +ZTB     any          same          block_sparse   dense w/ zero blocks

Non-adaptive architectures (WS/DiP baselines, modeled TPUv4i) run every
precision through the dense backend at R = 1 — sub-byte weights are
expanded to the native datapath width, exactly as the simulator's
``weight_bytes_per_element`` assumes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.config import AcceleratorConfig

DENSE = "dense"
BITLINEAR = "bitlinear"
BLOCK_SPARSE = "block_sparse"

MODE_NAMES = {2: "W1.58", 4: "W4", 8: "W8"}


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One resolved execution mode for a StagePlan on a config."""

    name: str            # W1.58 / W4 / W8, "+ZTB" suffix when sparse
    weight_bits: int
    r: int               # replication factor (N-tile width multiplier)
    backend: str         # tile_gemm dispatch key
    packed: bool         # stationary operand travels sub-byte packed
    sparse: bool = False

    def n_tile(self, d: int) -> int:
        """Accumulator output width per pass: R * D columns."""
        return self.r * d

    def weight_bytes_per_element(self, cfg: AcceleratorConfig) -> float:
        """Bytes per stationary element over the memory edge.

        Delegates to the config (not the executed layout) so traced traffic
        stays comparable to ``simulate()`` even in sparse mode, where the
        kernel consumes dense weights but the architecture would still ship
        them packed.
        """
        return cfg.weight_bytes_per_element(self.weight_bits)


def select_mode(
    cfg: AcceleratorConfig, weight_bits: int, *, sparse: bool = False,
) -> ModeSpec:
    """Resolve (config, precision, sparsity) -> execution mode.

    Mirrors the simulator's accounting choices exactly: R comes from
    ``cfg.r`` (1 unless the architecture is adaptive) and packing from
    ``cfg.packed_weights`` — so runtime-measured traffic is comparable to
    ``simulate()`` on the same config.
    """
    if weight_bits not in MODE_NAMES:
        raise ValueError(f"unsupported weight_bits={weight_bits}")
    r = cfg.r(weight_bits)
    packed = bool(cfg.packed_weights) and weight_bits < 8
    if sparse:
        backend = BLOCK_SPARSE
    elif packed:
        backend = BITLINEAR
    else:
        backend = DENSE
    name = MODE_NAMES[weight_bits] + ("+ZTB" if sparse else "")
    return ModeSpec(
        name=name, weight_bits=weight_bits, r=r, backend=backend,
        packed=packed and backend == BITLINEAR, sparse=sparse,
    )
