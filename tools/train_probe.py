#!/usr/bin/env python3
"""Probes of the training path at full width, on one CUDA card.

    python3 tools/train_probe.py grad            # gradient check
    python3 tools/train_probe.py lr 1e-3 1e-4    # losses by learning rate
    python3 tools/train_probe.py lr 1e-5 3e-5 --arch zamba2-7b --layers 12

``grad``: one loss and gradient of BitNet-1.58B (bf16, random weights from
a seeded torch.Generator, one 4096-token sequence) through the flash
kernels, then the same with the attention layer's flash call replaced by
autograd through the float32 plain forward (``attention_ref``); prints
both losses and, per gradient leaf, the relative L2 error and the cosine
between the two.

``lr``: for each learning rate given, AdamW from the same initial state
on the same sequence repeated for ``--steps`` steps; prints the losses
and the seconds.  ``--arch`` names the registry config (BitNet-1.58B by
default) and ``--layers`` cuts its depth (0: the config's own).

Prints the card's name and power limit first, one JSON line per result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _model(seq: int, arch: str = "bitnet-1.58b", layers: int = 0):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(layers=layers)
    api = build_model(cfg)
    batch = {k: torch.from_numpy(v).to(api.device) for k, v in
             synthetic_batch(cfg, batch=1, seq=seq, step=0).items()}

    def params():
        gen = torch.Generator(device=api.device)
        gen.manual_seed(0)
        return api.init(gen)

    return api, batch, params


def grad(seq: int) -> None:
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import value_and_grad

    api, batch, params = _model(seq)
    p = params()
    loss_k, g_kernel = value_and_grad(api.loss, p, batch)

    def plain(q, k, v, causal=True):
        b, h, s, d = q.shape
        hkv = k.shape[1]
        out = attention_ref(q.float().reshape(b * h, s, d),
                            k.float().reshape(b * hkv, s, d),
                            v.float().reshape(b * hkv, s, d), q_heads=h,
                            kv_heads=hkv, causal=causal)
        return out.reshape(b, h, s, d).to(q.dtype)

    kernel_path = attention.flash_attention
    attention.flash_attention = plain
    try:
        loss_p, g_plain = value_and_grad(api.loss, p, batch)
    finally:
        attention.flash_attention = kernel_path
    leaves = []
    for a, b in zip(tree_leaves(g_kernel), tree_leaves(g_plain)):
        a, b = a.float(), b.float()
        leaves.append({"shape": list(a.shape),
                       "rel_l2": float((a - b).norm() / b.norm()),
                       "cosine": float((a * b).sum()
                                       / (a.norm() * b.norm()))})
    print(json.dumps({"probe": "grad", "seq": seq,
                      "loss_kernels": float(loss_k),
                      "loss_plain_attention": float(loss_p),
                      "leaves": leaves}), flush=True)


def lr(rates, seq: int, steps: int, arch: str, layers: int) -> None:
    import torch

    from repro_torch.train import AdamW, build_train_step
    from repro_torch.train.train_loop import TrainState

    api, batch, params = _model(seq, arch, layers)
    for rate in rates:
        opt = AdamW(lr=rate)
        p = params()
        state = TrainState(p, opt.init(p))
        step = build_train_step(api, opt)
        losses = []
        t = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        print(json.dumps({"probe": "lr", "arch": arch,
                          "layers": api.cfg.layers, "lr": rate, "seq": seq,
                          "losses": losses,
                          "seconds": time.perf_counter() - t}), flush=True)
        del state, p, step
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("grad", "lr"))
    ap.add_argument("rates", nargs="*", type=float)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--arch", default="bitnet-1.58b")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.probe == "grad":
        grad(args.seq)
    else:
        lr(args.rates, args.seq, args.steps, args.arch, args.layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
