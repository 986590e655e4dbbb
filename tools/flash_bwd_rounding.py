#!/usr/bin/env python3
"""How tightly ``chip_smoke.py``'s ``flash_bwd`` phase holds the bf16
backward, on one CUDA card.

    python3 tools/flash_bwd_rounding.py

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as committed and a
variant that rounds ds once to bf16 in dk += ds^T q and dq += ds k (the
committed kernel splits it into ds_hi + ds_lo), into ``build/ablations/``
with the package's nvcc flags.  Runs both through
``chip_smoke.flash_bwd_errors`` at every bf16 row of
``chip_smoke.FLASH_BWD_SHAPES`` (the committed kernel at the float32 row
too) and prints one JSON line per (variant, row): each gradient's max abs
error, the atol in units of the reference's rms that the type's rtol
leaves to cover, and what ``chip_smoke.flash_bwd_failures`` finds.  Exits
1 unless the committed kernel passes every row and the variant fails every
bf16 row.  Prints the card's name and power limit first.  Imports nothing
of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "ablations")
# the two products whose ds operand is split (dk += ds^T q, dq += ds k),
# and the same products with ds rounded once
SPLIT = "rs_product<KS, true>"
ONCE = "rs_product<KS, false>"


def single_rounding(src: str) -> str:
    """The kernel source with ds rounded once to bf16."""
    if src.count(SPLIT) != 2:
        raise ValueError(f"expected two '{SPLIT}' in the kernel source")
    return src.replace(SPLIT, ONCE)


def build_variant(src: str):
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "flash_attention_bwd_single.cu")
    lib = os.path.join(OUT, "libflash_attention_bwd_single.so")
    with open(cu, "w") as f:
        f.write(single_rounding(src))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["flash_attention", "flash_attention_bwd"])
    committed = build.library("flash_attention_bwd")
    single = build_variant((build.CSRC / "flash_attention_bwd.cu").read_text())
    failed = {}
    for variant, lib in (("committed", committed), ("single", single)):
        build._LIBS["flash_attention_bwd"] = lib
        failed[variant] = []
        for label, h, hkv, s, d, causal, dtype, dout in cs.FLASH_BWD_SHAPES:
            if variant == "single" and dtype != "bfloat16":
                continue        # the float32 kernel has no ds rounding
            errs, *_ = cs.flash_bwd_errors(h, hkv, s, d, causal,
                                           getattr(torch, dtype),
                                           7 * s + h + hkv + d, dout)
            fails = cs.flash_bwd_failures(errs, getattr(torch, dtype))
            del errs["_checks"]
            if fails:
                failed[variant].append(label)
            print(json.dumps({"variant": variant, "shape": label,
                              "errors": errs, "fails": fails}), flush=True)
            del errs
            torch.cuda.empty_cache()
    build._LIBS["flash_attention_bwd"] = committed
    ok = not failed["committed"] and len(failed["single"]) == sum(
        dtype == "bfloat16" for *_, dtype, _ in cs.FLASH_BWD_SHAPES)
    print(json.dumps({"bound": cs.BWD_ATOL_RMS, "failed": failed,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
