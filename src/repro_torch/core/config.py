"""Hardware configuration objects for D-Legion and the rival architectures.

The paper's architecture hierarchy is:

    D-Legion = L Legions x (C ADiP cores) x (D x D reconfigurable PEs)

with adaptive precision R = 8 / weight_bits (R = 1 for 8bx8b dense mode,
R = 2 for 8bx4b, R = 4 for 8bx2b projection mode).  Rival architectures
(WS, DiP, ADiP) are modeled as single-core systolic arrays; Google TPUv4i
is modeled as four parallel 128x128 weight-stationary MXUs (paper SS V-C).

Peak throughput (ops/cycle) reproduces the paper's numbers exactly:

    peak = L * (C * D^2 * 2 * R  +  (C + 1) * R * D)
           ^^^^^^^^^^^^^^^^^^^^     ^^^^^^^^^^^^^^^
           PE multiply+add          Legion accumulator adders (C-input
                                    spatial reduction tree + temporal RMW)

    L=8,C=8,D=16,R=4  ->  135.68 TOPS @ 1 GHz   (paper abstract)
    L=8,C=8,D=16,R=1  ->   33.92 TOPS           (paper SS V-A, act-to-act)
    L=64              -> 1085.44 TOPS           (paper SS V-B)
"""
from __future__ import annotations

import dataclasses
import enum


class Dataflow(enum.Enum):
    """Systolic dataflow family — selects the per-tile latency formula."""

    WS = "ws"        # weight stationary w/ input+output sync FIFOs
    DIP = "dip"      # diagonal-input-permuted-weight (no sync FIFOs)
    ADIP = "adip"    # DiP + adaptive precision (reconfigurable PEs)


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """A many-core accelerator: ``units`` independent Legions/MXUs, each with
    ``cores`` systolic arrays of ``d x d`` PEs.

    WS / DiP / ADiP single-core baselines use units=1, cores=1.
    """

    name: str
    dataflow: Dataflow
    units: int = 1            # L — Legions (or parallel MXUs for TPUv4i)
    cores: int = 1            # C — cores per unit, K-split w/ spatial psum reduce
    d: int = 16               # D — systolic array rows/cols
    pipeline: int = 4         # P — pipeline stages (eq. 2)
    freq_hz: float = 1.0e9
    adaptive: bool = False    # supports R>1 (8bx4b / 8bx2b modes)
    packed_weights: bool = False  # loads sub-byte weights packed (vs int8-expanded)
    accumulators: int = 4     # parallel Legion accumulators (psum spatial reduce)
    psum_bank_mb: float = 0.66
    psum_banks: int = 4
    dtype_bytes: float = 1.0  # operand width (1 = int8 datapath, 2 = bf16)
    mapping_override: str = ""  # force a mapping policy (TPUv4i: GEMMs are
    #                             N-partitioned across MXUs, not head-parallel)

    # ------------------------------------------------------------------ #
    def r(self, weight_bits: int) -> int:
        """Acceleration ratio R for a given weight precision (paper eq. 1)."""
        if not self.adaptive:
            return 1
        if weight_bits not in (2, 4, 8):
            raise ValueError(f"unsupported weight_bits={weight_bits}")
        return 8 // weight_bits

    @property
    def total_pes(self) -> int:
        return self.units * self.cores * self.d * self.d

    def peak_ops_per_cycle(self, r: int = 1) -> int:
        """PE MACs (2 ops) + Legion accumulator adds per cycle."""
        pe_ops = self.cores * self.d * self.d * 2 * r
        if self.cores > 1:
            # C-input spatial reduction tree + temporal RMW adders operate on
            # an R*D-wide interleaved output stream (paper SS IV-A.2).
            acc_ops = (self.cores + 1) * r * self.d
        else:
            acc_ops = 0
        return self.units * (pe_ops + acc_ops)

    def peak_tops(self, r: int = 1) -> float:
        return self.peak_ops_per_cycle(r) * self.freq_hz / 1e12

    def weight_bytes_per_element(self, weight_bits: int) -> float:
        """Bytes fetched from memory per stationary-matrix element."""
        if self.packed_weights:
            return weight_bits / 8.0
        return self.dtype_bytes  # expanded to the native datapath width

    def scaled(self, units: int, name: str | None = None) -> "AcceleratorConfig":
        """Linear Legion scaling (paper SS V-B)."""
        return dataclasses.replace(
            self, units=units, name=name or f"{self.name}x{units}"
        )


# --------------------------------------------------------------------------- #
# Canonical instances (paper SS V).
# --------------------------------------------------------------------------- #

def ws_64() -> AcceleratorConfig:
    return AcceleratorConfig(
        name="WS-64x64", dataflow=Dataflow.WS, units=1, cores=1, d=64,
        pipeline=0, adaptive=False, packed_weights=False,
    )


def dip_64() -> AcceleratorConfig:
    return AcceleratorConfig(
        name="DiP-64x64", dataflow=Dataflow.DIP, units=1, cores=1, d=64,
        pipeline=0, adaptive=False, packed_weights=False,
    )


def adip_64() -> AcceleratorConfig:
    return AcceleratorConfig(
        name="ADiP-64x64", dataflow=Dataflow.ADIP, units=1, cores=1, d=64,
        pipeline=4, adaptive=True, packed_weights=True,
    )


def dlegion(legions: int = 8, cores: int = 8, d: int = 16) -> AcceleratorConfig:
    return AcceleratorConfig(
        name=f"D-Legion-{legions}L", dataflow=Dataflow.ADIP, units=legions,
        cores=cores, d=d, pipeline=4, adaptive=True, packed_weights=True,
    )


def tpuv4i() -> AcceleratorConfig:
    """Modeled Google TPUv4i: 4 MXUs of 128x128 @ 1.05 GHz (paper SS V-C).

    int8 operands (the workloads are quantized) and N-partitioned GEMM
    execution across the four MXUs — a TPU runs one XLA op at a time over
    all MXUs; it has no D-Legion-style independent per-head workload
    streams.  With this model D-Legion V2 lands at 2.4-3.4x latency /
    2.3-3.0x memory vs the paper's "up to 2.5x / 2.7x" (the paper does not
    specify its TPU modeling assumptions; see EXPERIMENTS.md).
    """
    return AcceleratorConfig(
        name="TPUv4i", dataflow=Dataflow.WS, units=4, cores=1, d=128,
        pipeline=0, freq_hz=1.05e9, adaptive=False, packed_weights=False,
        dtype_bytes=1.0, mapping_override="n_partition",
    )
