"""The readings that the cells' limits are set from, on the card.

    python3 -m portbench.gaps --workload NAME --seeds 1,2,3 \\
        [--faults unchanged,half_batch,altered] [--refs fp8,bfloat16] \\
        [--dtype float32] [--layers N] [--out FILE]

For each seed: the program's first steps (``kinds.train.Program``), sound
and with each fault planted, and the reference's, all from the same weights
and batches; then each one's gaps (``compare.gaps``) against the float32
reference.  ``--refs`` adds the reference in other modes
(``reference.common.Precision``), each against the float32 reference and
the program against each: ``fp8``, computed in fp8 in the program's place
(the control that has to fail); ``bfloat16``, rounded where the program
stores bfloat16; ``float64``, computed in float64 (the witness of what
float32 rounding alone moves).  ``--dtype`` / ``--layers`` run the
configuration in another stored type or at another depth (diagnostics).
One JSON line a seed and variant, on standard output and in ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import compare, gen
from portbench.kinds import train
from portbench.run import ROOT, cell_context, set_cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--refs", default="")
    p.add_argument("--dtype")
    p.add_argument("--layers", type=int)
    p.add_argument("--out")
    args = p.parse_args(argv)
    set_cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    ctx = cell_context(ROOT, args.workload)
    spec = dict(ctx["config"]["as_run"])
    if args.dtype:
        spec["dtype"] = args.dtype
    if args.layers:
        spec["layers"] = args.layers
    opt, traffic = ctx["config"]["train"], ctx["traffic"]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = {}
        for fault in [None] + faults:
            t = time.perf_counter()
            prog = train.Program(spec, opt, seed, "cuda", fault)
            batches = gen.TokenBatches(traffic, spec["vocab"], seed,
                                       prog.device)
            readings[fault or "program"], kept = prog.first_steps(batches)
            readings[fault or "program"]["seconds"] = (
                time.perf_counter() - t)
            del prog
            gc.collect()
            torch.cuda.empty_cache()
        refs = {}
        modes = [m for m in args.refs.split(",") if m]
        for mode in ["float32"] + modes:
            t = time.perf_counter()
            refs[mode] = train.reference_readings(spec, opt, seed, kept,
                                                  "cuda", mode)
            refs[mode]["seconds"] = time.perf_counter() - t
            torch.cuda.empty_cache()
        base = refs["float32"]
        rows = dict(readings)
        rows.update({("control" if m == "fp8" else f"{m}_reference"): refs[m]
                     for m in modes})
        for name, got in rows.items():
            emit({"workload": args.workload, "seed": seed, "variant": name,
                  "dtype": spec["dtype"], "layers": spec["layers"],
                  "gaps": compare.gaps(got, base),
                  "losses": got["losses"], "reference_losses":
                  base["losses"], "seconds": got["seconds"],
                  "reference_seconds": base["seconds"],
                  "readings": {k: got[k] for k in ("grad", "change")}})
        emit({"workload": args.workload, "seed": seed,
              "variant": "float32_reference", "readings": {
                  k: base[k] for k in ("losses", "grad", "change")}})
        for m in modes:
            emit({"workload": args.workload, "seed": seed,
                  "variant": f"program_vs_{m}_reference",
                  "gaps": compare.gaps(readings["program"], refs[m])})
    return 0


if __name__ == "__main__":
    sys.exit(main())
