"""Probe: is a fresh process's first float32 ``torch.exp`` on the CPU right?

Starts ``--procs`` fresh Python processes, ``--jobs`` at a time (they load
the CPU, as a parallel test run does). Each one calls ``torch.exp`` four
times on the decay exponents of the SSD chunked plain version (segment
sums of a [3, 4, 32, 32] chunk grid, -1e30 above the diagonal) and
compares every result with numpy's float64 ``exp`` (not torch's, so that
the float32 call is the process's first ``torch.exp``). Prints how many
first calls and how many later calls were off by more than 1e-6, and the
largest error of each.

    python3 tools/first_exp_probe.py --procs 400 --jobs 6
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = """
import json, numpy, torch
g = torch.Generator().manual_seed(0)
la = torch.cumsum(-torch.rand(3, 4, 32, generator=g) * 0.1, -1)
idx = torch.arange(32)
lower = idx[:, None] >= idx[None, :]
seg = torch.where(lower, la[..., :, None] - la[..., None, :],
                  torch.tensor(-1e30))
want = torch.from_numpy(numpy.exp(seg.double().numpy()))
print(json.dumps([float((torch.exp(seg).double() - want).abs().max())
                  for _ in range(4)]))
"""


def one(_: int) -> list:
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args()
    with ThreadPoolExecutor(args.jobs) as pool:
        errs = list(pool.map(one, range(args.procs)))
    first = [e[0] for e in errs]
    later = [x for e in errs for x in e[1:]]
    print(json.dumps({
        "procs": len(errs),
        "first_calls_off": sum(x > 1e-6 for x in first),
        "first_max_err": max(first),
        "later_calls": len(later),
        "later_calls_off": sum(x > 1e-6 for x in later),
        "later_max_err": max(later),
    }))


if __name__ == "__main__":
    main()
