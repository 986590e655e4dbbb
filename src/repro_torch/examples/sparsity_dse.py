"""Design-space exploration + ZTB sparsity sweep (paper SS III / SS IV-A.4),
on the port's copy of ``core``, which computes in NumPy and Python; like
every entry point of the port it asks for the card (``--device``) all the
same, and runs without one only with ``--device cpu``.

    python -m repro_torch.examples.sparsity_dse [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core import (
    attention_workloads,
    bitnet_1_58b,
    dlegion,
    simulate,
)
from repro_torch.core.analytical import cri, tfu_cycles, unit_input_bandwidth
from repro_torch.core.config import AcceleratorConfig, Dataflow
from repro_torch.core.sparsity import ZTBStats
from repro_torch.core.workloads import corner_case_workloads
from repro_torch.device import resolve_device


def legion_cfg(c, d):
    return AcceleratorConfig(
        name=f"{c}x{d}x{d}", dataflow=Dataflow.ADIP, units=1, cores=c, d=d,
        pipeline=4, adaptive=True, packed_weights=True,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    resolve_device(ap.parse_args(argv).device)
    print("== Legion granularity (paper Fig. 3/4) ==")
    wl = corner_case_workloads()
    print(f"{'config':>10s} {'PEs':>6s} {'TFU':>4s} {'in-BW':>6s} "
          f"{'CRI':>8s}")
    for c, d in [(2, 64), (4, 32), (8, 16), (16, 8)]:
        cfg = legion_cfg(c, d)
        print(f"{cfg.name:>10s} {cfg.total_pes:>6d} {tfu_cycles(cfg):>4d} "
              f"{unit_input_bandwidth(cfg):>6d} {cri(cfg, wl):>8.0f}")
    print("-> 8x16x16 selected (highest CRI among configs with 2x the PEs "
          "of 16x8x8), matching the paper.\n")

    print("== ZTB block-structured sparsity sweep (D-Legion, "
          "BitNet-1.58B) ==")
    wl = attention_workloads(bitnet_1_58b())
    dense = simulate(dlegion(), wl)
    print(f"{'window sparsity':>16s} {'latency x':>10s} {'memory x':>9s} "
          f"{'psum x':>7s}")
    for frac in (0.0, 0.25, 0.5, 0.75):
        ztb = ZTBStats(fully_sparse_fraction=frac, zero_tile_fraction=frac,
                       num_windows=100, num_tiles=800)
        rep = simulate(dlegion(), wl, ztb=ztb)
        print(f"{frac:>16.2f} {dense.total_cycles/rep.total_cycles:>10.2f} "
              f"{dense.total_mem_gb/rep.total_mem_gb:>9.2f} "
              f"{dense.total_psum_gb/rep.total_psum_gb:>7.2f}")
    print("\n(fully-sparse windows skip compute, transfers and accumulator "
          "updates; act-to-act stages are unaffected — ZTB lives on weights)")


if __name__ == "__main__":
    main()
