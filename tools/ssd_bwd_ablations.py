#!/usr/bin/env python3
"""Ablations of the SSD backward's scan kernel (kernel 3 of
``csrc/ssd_bwd.cu``) at Zamba2-7B's and Mamba2-130m's training shapes, on
one CUDA card.

    python3 tools/ssd_bwd_ablations.py [VARIANT ...]

Builds variants of ``src/repro_torch/csrc/ssd_bwd.cu``, each one text
substitution of the source (most compute wrong results on purpose: they
time what is left; each cut product's result stays in use, so that the
compiler drops nothing else), into ``build/ablations_ssd_bwd/`` with the
package's nvcc flags, swaps each in under ``ops._launch_bwd`` and times
the scan kernel's device µs per call (torch.profiler, 5 calls) on the same
inputs at the first two rows of ``chip_smoke.SSD_BWD_SHAPES``, the base
first and last.  Prints the card's name and power limit, each variant's
registers and spills, then one JSON line per measurement with the largest
difference of its gradients from the base's.  Imports nothing of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "ablations_ssd_bwd")

STATE_PRODUCTS = (
    "      rect_dense(acc, c_at, h_at, kn, a, half, g, t);\n",
    "      rect_dense(dx, b_at, g_at, kn, a, half, g, t);\n",
    "      rect_dense(acc, y_at, ht_at, kp, a, half, g, t);\n",
    "      rect_dense(acc, x_at, gt_at, kp, a, half, g, t);\n")


def variants(src: str):
    """name -> source: the base and one cut or change each."""
    def sub(text, old, new=""):
        if old not in text:
            raise SystemExit(f"ablation anchor not found: {old[:60]!r}")
        return text.replace(old, new)

    no_state = src
    for line in STATE_PRODUCTS:
        no_state = sub(no_state, line)
    partial = ("put_rows(part_{0}, sd{0}.s, acc, {1}, n0, q, N, hh == 0,",
               "put_rows(part_{0}, sd{0}.s, acc, {1}, n0, q, N, true,")
    stores = src
    for which, scale in (("c", "ev"), ("b", "fv")):
        stores = sub(stores, partial[0].format(which, scale),
                     partial[1].format(which, scale))
    unroll = src
    for loop in ("  for (int k0 = 0; k0 < K; k0 += 8) {\n    const FragA f",
                 "    for (int k0 = klo[sp]; k0 < khi[sp]; k0 += 8) {"):
        unroll = sub(unroll, loop, "#pragma unroll 2\n" + loop)
    return {
        "base": src,
        # dy x^T (M1 then zero: the epilogue still runs)
        "no_s1": sub(src, "      tri_product(s1, y_at, xt_at, kp, a, half, "
                          "g, t);\n"),
        # the decay mask's exp in the dy x^T epilogue
        "no_exp": sub(src, "const float l = j <= i ? expf(lai - la[j]) : "
                           "0.0f;",
                      "const float l = j <= i ? lai : 0.0f;"),
        # the four state products (C H_in, B G, dy H_in^T, x G^T)
        "no_state": no_state,
        # the partials' loads (every head stores, none adds)
        "stores_only": stores,
        # dx's triangular product M2^T dy
        "no_dx": sub(src, "      rect_tri(dx, wt_at, y_at, klo, khi, a, "
                          "half, g, t);\n"),
        # the group's (sum M1) B and (sum M1)^T C
        "no_group_products": sub(sub(
            src, "      rect_tri(acc, w_at, b_at, klo, khi, a, half, g, "
                 "t);\n"),
            "      rect_tri(acc, wt_at, c_at, klo, khi, a, half, g, t);\n"),
        # dy and x staged for the first head only
        "no_stage_yx": sub(sub(
            src, "    stage_zero<PMAX>(ys, TP, dy + bi",
            "    if (hh == 0) stage_zero<PMAX>(ys, TP, dy + bi"),
            "    stage_zero<PMAX>(xs, TP, dtx + bi",
            "    if (hh == 0) stage_zero<PMAX>(xs, TP, dtx + bi"),
        # the small terms of 3xTF32 dropped: one TF32 product
        "one_term": sub(src, "  if (term == 0)\n    mma_tf32(d, a.lo, b.hi);"
                             "\n  else if (term == 1)\n    mma_tf32(d, a.hi, "
                             "b.lo);\n  else\n    mma_tf32(d, a.hi, b.hi);",
                        "  if (term == 2) mma_tf32(d, a.hi, b.hi);"),
        # the depth loops unrolled by two
        "unroll_2": unroll,
    }


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    src = open(os.path.join(build.CSRC, "ssd_bwd.cu")).read()
    todo = variants(src)
    if len(sys.argv) > 1:
        todo = {k: todo[k] for k in ["base", *sys.argv[1:]]}
    procs = {}
    for name, text in todo.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "ssd_bwd.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "ssd_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if "Compiling entry" in ln and "kernel_scan" in ln)
        print(json.dumps({"variant": name, "scan_ptxas": [
            ln.strip() for ln in lines[at + 1:at + 4]
            if "registers" in ln or "spill" in ln]}), flush=True)
        libs[name] = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
    build.build(["ssd"])
    order = [*libs, "base"]
    for label, nb, nh, s, n, p, chunk, _ in cs.SSD_BWD_SHAPES[:2]:
        dta, dtx, b4, c4 = cs.ssd_operands(nb, nh, s, n, p, s + n + 1)
        gen = torch.Generator(device="cuda").manual_seed(s + p)
        dy = torch.randn(nb, s, nh, p, device="cuda",
                         generator=gen).transpose(1, 2)
        scratch = ops._scratch(dtx, n, chunk)
        ops._launch(dta, dtx, b4, c4, chunk, False, scratch)
        call = lambda i: ops._launch_bwd(                  # noqa: E731
            dta, dtx, b4[:, 0], c4[:, 0], dy, scratch, None, None, chunk)
        ref = None
        for name in order:
            build._LIBS["ssd_bwd"] = libs[name]
            out = call(0)
            if ref is None:
                ref = [t.clone() for t in out]
            by_kernel = cs.device_us_by_kernel(
                call, 5, cs.SSD_BWD_KERNELS, per_call=len(cs.SSD_BWD_KERNELS))
            print(json.dumps({
                "shape": label, "variant": name,
                "scan_us": by_kernel and by_kernel["ssd_bwd_kernel_scan"],
                "max_abs_diff_from_base": max(
                    float((a - b).abs().max()) for a, b in zip(out, ref))}),
                flush=True)
        del ref, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
