#!/usr/bin/env python3
"""The bf16 flash kernels of this checkout against those of another
source tree, on one CUDA card, in turns.

    python3 tools/flash_ab.py BASELINE_CSRC

BASELINE_CSRC holds another version's ``flash_attention.cu`` and
``flash_attention_bwd.cu`` (with their headers), e.g. the ``csrc/`` of an
earlier commit unpacked by ``git archive`` into the ignored ``build/``.
Builds both versions with the package's nvcc flags (the baseline into
``build/ab/``) and swaps the loaded libraries under the wrappers, so both
run through ``ops._launch`` / ``ops._launch_bwd`` on the same inputs: the
forward at phase 10's bf16 shapes and the backward at every bf16 row of
``chip_smoke.FLASH_BWD_SHAPES`` with standard-normal dout.  Each shape
runs baseline, checkout, checkout, baseline (``chip_smoke.cuda_ms``, 10
calls each) and prints one JSON line per turn, with whether the forward's
outputs are bit-equal across versions and the backward's largest
difference.  Prints the card's name and power limit first.  Imports
nothing of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "ab")
# phase 10's bf16 forward rows: (label, H, Hkv, S, d, causal)
FORWARD_SHAPES = (
    ("zamba2-7b prefill", 32, 32, 4096, 112, True),
    ("granite-moe-3b-a800m prefill", 24, 8, 4096, 64, True),
    ("hubert-xlarge", 16, 16, 4096, 80, False),
    ("internvl2-76b prefill", 64, 8, 4096, 128, True))


def build_baseline(csrc: str):
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    libs = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        lib = os.path.join(OUT, f"lib{name}_baseline.so")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-o", lib,
             os.path.join(csrc, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the baseline {name}.cu:\n"
                             f"{proc.stdout}{proc.stderr}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def inputs(h, hkv, s, d, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(
        (1, s, n, d)).astype(np.float32)).to(
            device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        for n in (h, hkv, hkv, h)]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    build.build(["flash_attention", "flash_attention_bwd"])
    versions = {"checkout": {n: build.library(n) for n in
                             ("flash_attention", "flash_attention_bwd")},
                "baseline": build_baseline(sys.argv[1])}
    turns = ("baseline", "checkout", "checkout", "baseline")

    def run(kind, label, call):
        outs = {}
        for version in turns:
            build._LIBS.update(versions[version])
            outs.setdefault(version, [t.float() for t in call(0)])
            ms = cs.cuda_ms(call, 10)
            print(json.dumps({"kernel": kind, "shape": label,
                              "version": version, "ms": ms}), flush=True)
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(outs["checkout"], outs["baseline"]))
        print(json.dumps({"kernel": kind, "shape": label,
                          "max_abs_diff_between_versions": diff}),
              flush=True)
        return diff

    same = True
    for label, h, hkv, s, d, causal in FORWARD_SHAPES:
        q, k, v, _ = inputs(h, hkv, s, d, s + h + hkv + d)
        same &= run("forward", label, lambda i: (
            fa._launch(q, k, v, causal, d ** -0.5),)) == 0.0
    for label, h, hkv, s, d, causal, dtype, dout in cs.FLASH_BWD_SHAPES:
        if dtype != "bfloat16" or dout != "normal":
            continue
        q, k, v, do = inputs(h, hkv, s, d, 7 * s + h + hkv + d)
        build._LIBS.update(versions["checkout"])
        o, lse = fa._launch(q, k, v, causal, d ** -0.5, with_lse=True)
        run("backward", label, lambda i: fa._launch_bwd(
            q, k, v, o, lse, do, causal, d ** -0.5))
        torch.cuda.empty_cache()
    build._LIBS.update(versions["checkout"])
    print(json.dumps({"forward_bit_equal": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
