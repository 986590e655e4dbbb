#!/usr/bin/env python3
"""The SSD backward kernels of this checkout against those of another
source tree, on one CUDA card, in turns.

    python3 tools/ssd_bwd_ab.py BASELINE_CSRC
    python3 tools/ssd_bwd_ab.py --groups 4,6,8,12,14,16

BASELINE_CSRC holds another version's ``ssd_bwd.cu`` and ``ssd.cuh``, e.g.
the ``csrc/`` of an earlier commit unpacked by ``git archive`` into the
ignored ``build/``.  Builds both versions with the package's nvcc flags
(the baseline into ``build/ab/``) and swaps the loaded library under the
wrapper, so both run through ``ops._launch_bwd`` on the same inputs at
every row of ``chip_smoke.SSD_BWD_SHAPES``, from the forward kernel's
scratch.  A baseline whose entry point takes no head group (the per-head
kernels before the head groups) is called without it, on per-head dB and
dC scratch.  Each shape runs baseline, checkout, checkout, baseline
(``chip_smoke.cuda_ms``, 10 calls each; the device time of each kernel
from one profiler trace of 3 calls) and prints one JSON line per turn,
then the largest difference between the versions' gradients.  Prints the
card's name and power limit first.  Imports nothing of JAX.

With ``--groups``, times this checkout's kernels alone at each listed head
group G (``ops.head_group`` replaced; the G above a row's head count are
left out) at every row, the list in order and then reversed, and prints
one JSON line per turn beside the G that ``ops.head_group`` chooses, with
the largest difference of the gradients from that G's.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "ab")


class _NoGroup:
    """A baseline library whose ``ssd_bwd_launch`` takes no head group,
    behind the checkout's call (``lib.ssd_bwd_launch(...)``, its
    ``argtypes`` set): the group argument is dropped."""

    def __init__(self, lib):
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        self._fn = lib.ssd_bwd_launch
        self._fn.argtypes = [vp, ll, ll, ll] * 9 + [vp] * 7 + [ci] * 6 + [vp]
        self._fn.restype = ci
        self.argtypes = self._fn.argtypes
        self.ssd_bwd_launch = self

    def __call__(self, *args):
        return self._fn(*args[:-2], args[-1])


def build_baseline(csrc: str):
    """(library, takes a head group) of the baseline's ssd_bwd.cu."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libssd_bwd_baseline.so")
    src = os.path.join(csrc, "ssd_bwd.cu")
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for the baseline ssd_bwd.cu:\n"
                         f"{proc.stdout}{proc.stderr}")
    grouped = "int group" in open(src).read()
    return ctypes.CDLL(lib), grouped


def rows():
    """(label, B, H, S, N, P, chunk, call) at each row of
    ``chip_smoke.SSD_BWD_SHAPES``: ``call(i)`` runs the backward through
    ``ops._launch_bwd`` on that row's inputs and the forward's scratch."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ssd import ops

    for label, nb, nh, s, n, p, chunk, with_dh in cs.SSD_BWD_SHAPES:
        dta, dtx, b4, c4 = cs.ssd_operands(nb, nh, s, n, p, s + n + 1)
        bm, cm = b4[:, 0], c4[:, 0]
        rng = np.random.default_rng(s + p)
        dy = torch.from_numpy(rng.standard_normal((nb, s, nh, p)).astype(
            np.float32)).cuda().transpose(1, 2)
        dh = (torch.from_numpy(rng.standard_normal((nb, nh, n, p)).astype(
            np.float32)).cuda() if with_dh else None)
        scratch = ops._scratch(dtx, n, chunk)
        _, h = ops._launch(dta, dtx, b4, c4, chunk, with_dh, scratch)
        yield label, nb, nh, s, n, p, chunk, (
            lambda i: ops._launch_bwd(dta, dtx, bm, cm, dy, scratch, h, dh,
                                      chunk))
        del dta, dtx, b4, c4, bm, cm, dy, dh, scratch, h
        torch.cuda.empty_cache()


def sweep_groups(groups) -> None:
    """This checkout's kernels at each head group in ``groups``."""
    import chip_smoke as cs
    from repro_torch.kernels.ssd import ops

    chosen = ops.head_group
    try:
        for label, nb, nh, s, n, p, chunk, call in rows():
            nc = -(-s // chunk)
            ref = [t.clone() for t in call(0)]
            gs = [g for g in groups if g <= nh]
            for g in gs + gs[::-1]:
                ops.head_group = lambda nb, nh, nc, g=g: g
                out = call(0)
                print(json.dumps({
                    "shape": label, "head_group": g,
                    "chosen": chosen(nb, nh, nc),
                    "blocks": -(-nh // g) * nc * nb,
                    "ms": cs.cuda_ms(call, 10),
                    "device_us_by_kernel": cs.device_us_by_kernel(
                        call, 3, cs.SSD_BWD_KERNELS,
                        per_call=len(cs.SSD_BWD_KERNELS)),
                    "max_abs_diff_from_chosen": max(
                        float((a - b).abs().max())
                        for a, b in zip(out, ref))}), flush=True)
                del out
            del ref
    finally:
        ops.head_group = chosen


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops

    if len(sys.argv) != 2 and not (len(sys.argv) == 3
                                   and sys.argv[1] == "--groups"):
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    build.build(["ssd", "ssd_bwd"])
    if sys.argv[1] == "--groups":
        sweep_groups([int(g) for g in sys.argv[2].split(",")])
        return 0
    base_lib, grouped = build_baseline(sys.argv[1])
    versions = {"checkout": (build.library("ssd_bwd"), ops.head_group),
                "baseline": (base_lib if grouped else _NoGroup(base_lib),
                             ops.head_group if grouped
                             else (lambda nb, nh, nc: 1))}
    turns = ("baseline", "checkout", "checkout", "baseline")
    for label, nb, nh, s, n, p, chunk, call in rows():
        outs = {}
        for version in turns:
            lib, group = versions[version]
            build._LIBS["ssd_bwd"], ops.head_group = lib, group
            outs.setdefault(version, call(0))
            print(json.dumps({
                "shape": label, "version": version,
                "head_group": group(nb, nh, -(-s // chunk)),
                "ms": cs.cuda_ms(call, 10),
                "device_us_by_kernel": cs.device_us_by_kernel(
                    call, 3, cs.SSD_BWD_KERNELS,
                    per_call=len(cs.SSD_BWD_KERNELS))}), flush=True)
        diff = {name: float((a - b).abs().max()) for name, a, b in zip(
            ("ddta", "ddtx", "db", "dc"), outs["checkout"],
            outs["baseline"])}
        print(json.dumps({"shape": label,
                          "max_abs_diff_between_versions": diff}),
              flush=True)
        del outs
    build._LIBS["ssd_bwd"], ops.head_group = versions["checkout"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
