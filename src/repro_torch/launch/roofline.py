"""Roofline analysis of a dry-run cell, the port of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), all in seconds:

    compute    = FLOPs        / (chips x peak_FLOP/s)
    memory     = bytes        / (chips x HBM_bw)
    collective = sum over mesh axes of
                 coll_bytes[axis] / (chips x link_bw[axis])

FLOPs, bytes and collective bytes come from the ATen-level counter of one
traced step (``repro_torch.launch.hlo_cost``), per device; they are
multiplied by the chip count so that the formulas above hold as written.
Collective bytes are the operands of the recorded functional collectives
(all-gather, all-reduce, reduce-scatter, all-to-all) that DTensor issues,
charged per mesh axis: where the JAX package has one link rate, an H100
cluster has two, so a collective is charged at the rate of the link its
axis crosses.

Hardware model (H100 SXM, per GPU): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
NVLink at 450 GB/s per direction for the in-pod ``data`` and ``model``
axes (a 256-GPU pod is one NVLink Switch domain), InfiniBand at 50 GB/s per
GPU across pods (the ``pod`` axis).  These are data-sheet rates, so every
time here is a prediction, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.kernels.cost import BF16_OPS_PER_S, HBM_BYTES_PER_S

PEAK_FLOPS = BF16_OPS_PER_S   # dense bf16 per GPU
HBM_BW = HBM_BYTES_PER_S      # bytes/s per GPU
NVLINK_BW = 450e9             # bytes/s per GPU, per direction, in a pod
IB_BW = 50e9                  # bytes/s per GPU across pods
LINK_BW: Dict[str, float] = {"data": NVLINK_BW, "model": NVLINK_BW,
                             "pod": IB_BW}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def link_bw(axis: str) -> float:
    """The link rate a collective over mesh axis ``axis`` crosses."""
    return LINK_BW.get(axis, NVLINK_BW)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # global (per-device x chips)
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    model_flops: float         # 6*N*D train / 2*N*D inference
    coll_by_axis: Dict[str, float]   # global collective bytes per mesh axis
    memory_per_device: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return sum(b / (self.chips * link_bw(a))
                   for a, b in self.coll_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def predicted_step_s(self) -> float:
        """The step time the roofline predicts: the largest of its terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """model-FLOPs time at peak / achievable step time (max of terms)."""
        t_model = self.model_flops / (self.chips * PEAK_FLOPS)
        t_step = self.predicted_step_s
        return t_model / t_step if t_step else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "coll_by_axis": self.coll_by_axis,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "predicted_step_s": self.predicted_step_s,
            "memory_per_device": self.memory_per_device,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for inference forwards."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens


def analyze(
    *, arch: str, shape_name: str, mesh_name: str, chips: int,
    cost: Dict, cfg, shape,
    memory_stats: Optional[Dict[str, float]] = None,
) -> RooflineReport:
    """A report from one device's counts (``hlo_cost.CostCounter.summary``:
    ``flops``, ``bytes``, ``collectives`` per kind and ``by_axis``)."""
    coll = cost.get("collectives", {})
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)) * chips,
        hlo_bytes=float(cost.get("bytes", 0.0)) * chips,
        coll_bytes=sum(coll.values()) * chips,
        coll_breakdown={k: v * chips for k, v in coll.items()},
        model_flops=model_flops(cfg, shape),
        memory_per_device=memory_stats,
        coll_by_axis={a: v * chips for a, v in cost["by_axis"].items()},
    )
