"""End-to-end QAT training driver: a ~100M-param BitNet-style model on the
deterministic synthetic corpus, with checkpoints, preemption handling and
restart, on the card (``--device cpu`` runs the plain versions).

    python -m repro_torch.examples.train_bitnet --steps 300

CI-scale smoke (default steps):

    python -m repro_torch.examples.train_bitnet --steps 20 --tiny

A run whose ``--ckpt-dir`` holds a checkpoint resumes from its last step.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import (
    AdamW,
    Checkpointer,
    TrainingRunner,
    build_train_step,
    cosine_schedule,
    init_train_state,
)


def model_100m() -> ModelConfig:
    """~100M params, BitNet-1.58B family (ternary QAT)."""
    return ModelConfig(
        name="bitnet-100m", family="dense", layers=10, d_model=768,
        n_heads=12, kv_heads=4, head_dim=64, d_ff=2048, vocab=32000,
        max_seq=1024,
    )


def model_tiny() -> ModelConfig:
    return model_100m().replace(
        name="bitnet-tiny", layers=4, d_model=256, n_heads=4, kv_heads=2,
        head_dim=64, d_ff=512, vocab=2048, remat="none",
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "bitnet_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def train(args, device, state=None, log=print, cfg=None):
    """``args.steps`` steps of the run ``args`` describes (its model,
    unless ``cfg`` is given, its schedule, batches and checkpoints), from
    ``--ckpt-dir``'s last checkpoint if there is one, else from ``state``
    if given, else from seed 0.  Returns the config, the runner (its
    final state), the step it resumed from, the logged metrics by step and
    the last step's metrics."""
    cfg = cfg or (model_tiny() if args.tiny else model_100m())
    api = build_model(cfg, device=device)
    log(f"arch={cfg.name}  params={cfg.param_count()/1e6:.1f}M  "
        f"quantization={cfg.quantization}")
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    if state is None:
        state = init_train_state(api, opt, 0)
    step = build_train_step(api, opt, grad_accum=args.grad_accum)

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(device) for k, v in
                synthetic_batch(cfg, batch=args.batch, seq=args.seq,
                                step=s).items()}

    logged = {}

    def log_step(s, m):
        logged[s] = {k: float(v) for k, v in m.items()}
        if s % 5 == 0 or s == 1:
            log(f"step {s:5d}  loss={float(m['loss']):.4f}  "
                f"gnorm={float(m['grad_norm']):.3f}")

    runner = TrainingRunner(step, batch_fn, state, Checkpointer(args.ckpt_dir),
                            ckpt_every=args.ckpt_every, device=device,
                            log_fn=log_step)
    resumed = runner.maybe_restore()
    if resumed:
        log(f"resumed from checkpoint at step {resumed}")
    metrics = runner.run(args.steps)
    if metrics:
        log(f"done: final loss={float(metrics['loss']):.4f} "
            f"(checkpoints in {args.ckpt_dir})")
    return {"cfg": cfg, "runner": runner, "resumed": resumed,
            "logged": logged, "metrics": metrics}


def main(argv=None):
    args = parser().parse_args(argv)
    return train(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
