#!/usr/bin/env python3
"""The flash and SSD wrappers of this checkout (each launch a
``torch.library`` custom op) against another version's wrappers, on one
CUDA card, in turns.

    python3 tools/launch_ab.py BASELINE_SRC

BASELINE_SRC is another version's ``src/`` (e.g. the parent commit's,
unpacked by ``git archive`` into the ignored ``build/``).  Its
``repro_torch/kernels/flash_attention/ops.py`` and ``kernels/ssd/ops.py``
are loaded as modules of their own beside this checkout's; both drive the
kernels this checkout builds (the CUDA sources are the same), so what is
compared is the wrapper: its host time and what it asks of the card.
Rows: the bf16 flash forward at phase 10's shapes (the serve path, no lse),
the BitNet-1.58B train shape's forward with the lse and its backward (the
launches ``FlashAttention`` makes), and the SSD scan at phase 9's Zamba2-7B
prefill.  Each row runs baseline, checkout, checkout, baseline and prints
one JSON line per turn: ``ms`` a call (CUDA events, chip_smoke.cuda_ms) and
``device_us``, the named kernels' device time a call (torch.profiler,
chip_smoke.device_us), and whether the outputs are bit-equal across the
versions.  Prints the card's name and power limit first.  Imports nothing
of JAX.
"""
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

FLASH_FWD = ("flash_kernel_bf16_wgmma",)
FLASH_BWD = ("flash_bwd_dot_kernel", "flash_bwd_dkdv_wgmma_kernel",
             "flash_bwd_dq_wgmma_kernel")
SSD = ("ssd_kernel_state", "ssd_kernel_pass", "ssd_kernel_scan")
TURNS = ("baseline", "checkout", "checkout", "baseline")


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16(shape, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    return torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(device="cuda", dtype=torch.bfloat16).transpose(1, 2)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd

    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    kernels = os.path.join(sys.argv[1], "repro_torch", "kernels")
    versions = {
        "checkout": {"fa": fa, "ssd": ssd},
        "baseline": {"fa": load(os.path.join(
            kernels, "flash_attention", "ops.py"), "baseline_fa_ops"),
            "ssd": load(os.path.join(kernels, "ssd", "ops.py"),
                        "baseline_ssd_ops")}}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    build.build(["flash_attention", "flash_attention_bwd", "ssd"])

    def run(row, make_call, names, per_call):
        outs = {}
        for version in TURNS:
            call = make_call(versions[version])
            out = call(0)
            outs.setdefault(version, [t.float() for t in out])
            print(json.dumps({
                "row": row, "version": version,
                "ms": cs.cuda_ms(call, 10),
                "device_us": cs.device_us(call, 5, names,
                                          per_call=per_call)}),
                flush=True)
        same = all(torch.equal(a, b) for a, b in
                   zip(outs["checkout"], outs["baseline"]))
        print(json.dumps({"row": row, "bit_equal": same}), flush=True)
        return same

    ok = True
    for label, h, hkv, s, d, causal in (
            ("zamba2-7b prefill", 32, 32, 4096, 112, True),
            ("granite-moe-3b-a800m prefill", 24, 8, 4096, 64, True),
            ("hubert-xlarge", 16, 16, 4096, 80, False),
            ("internvl2-76b prefill", 64, 8, 4096, 128, True)):
        q, k, v = (bf16((1, n, s, d), s + n + d) for n in (h, hkv, hkv))
        ok &= run(f"flash forward {label}", lambda m: (
            lambda i: (m["fa"].flash_attention(q, k, v, causal=causal),)),
            FLASH_FWD, 1)

    nb, nh, s, n, p = 1, 112, 4096, 64, 64
    dta, dtx, bm, cm = cs.ssd_operands(nb, nh, s, n, p, s + n)
    ok &= run("ssd zamba2-7b prefill", lambda m: (
        lambda i: m["ssd"].ssd(dta, dtx, bm, cm, chunk=128,
                               return_state=True)), SSD, 3)
    torch.cuda.empty_cache()

    # the train path's launches at the BitNet-1.58B train shape: the
    # forward with the lse and the backward, each through the version's
    # own launch (the baseline's ctypes call, the checkout's custom op)
    q, k, v, do = (bf16((1, 16, 4096, 128), 11 + n) for n in range(4))
    scale = 128 ** -0.5
    o, lse = fa._launch(q, k, v, True, scale, with_lse=True)

    def fwd_lse(m):
        if m["fa"] is fa:
            return lambda i: torch.ops.repro_torch.flash_fwd_lse(
                q, k, v, True, scale, 0)
        return lambda i: m["fa"]._launch(q, k, v, True, scale,
                                         with_lse=True)

    def bwd(m):
        if m["fa"] is fa:
            return lambda i: torch.ops.repro_torch.flash_bwd(
                q, k, v, o, lse, do, fa._rowdot(q), True, scale, 0)
        return lambda i: m["fa"]._launch_bwd(q, k, v, o, lse, do, True,
                                             scale)

    ok &= run("flash forward with lse bitnet-1.58b train", fwd_lse,
              FLASH_FWD, 1)
    ok &= run("flash backward bitnet-1.58b train", bwd, FLASH_BWD, 3)
    torch.cuda.empty_cache()

    print(json.dumps({"all_bit_equal": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
