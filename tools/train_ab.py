#!/usr/bin/env python3
"""A full-size train step of this checkout's port against another
version's, on one CUDA card, in turns.

    python3 tools/train_ab.py BASELINE_SRC [ARCH ...]

BASELINE_SRC is another version's ``src/`` (e.g. the parent commit's,
unpacked by ``git archive <rev> src | tar -x -C build/parent``).  ARCH
defaults to ``bitnet-1.58b mamba2-130m``: each at full size, as phases
train and ssm_train run them (bf16, QAT, the config's remat, AdamW at
the phase's learning rate, one 4096-token sequence).  Each arch runs
baseline, checkout, checkout, baseline, each in a process of its own that
imports only its version's ``repro_torch``: one warm-up step, then
``STEPS`` timed steps.  One JSON line per turn: ``step_s`` the wall
seconds of each timed step (ended by a synchronize), ``device_ms`` each
step's time between CUDA events, ``peak_bytes`` the peak allocated from
the state's creation on, and the last loss.  Prints the card's name and
power limit first.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("baseline", "checkout", "checkout", "baseline")
STEPS = 4
# the learning rates of chip_smoke's phases train and ssm_train
LR = {"bitnet-1.58b": 3e-5, "mamba2-130m": 3e-4}

WORKER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import get_config
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.train import AdamW, build_train_step, init_train_state

arch, lr, steps = sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
cfg = get_config(arch)
api = build_model(cfg)
opt = AdamW(lr=lr)
torch.cuda.reset_peak_memory_stats()
gen = torch.Generator(device=api.device)
gen.manual_seed(0)
state = init_train_state(api, opt, gen)
batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
    cfg, batch=1, seq=4096, step=0).items()}
step = build_train_step(api, opt)
state, m = step(state, batch)
torch.cuda.synchronize()
walls, device = [], []
for _ in range(steps):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    start.record()
    state, m = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
    device.append(start.elapsed_time(end))
print(json.dumps({"step_s": walls, "device_ms": device,
                  "peak_bytes": torch.cuda.max_memory_allocated(),
                  "loss": float(m["loss"])}))
"""


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    src = {"baseline": os.path.abspath(sys.argv[1]),
           "checkout": os.path.join(ROOT, "src")}
    archs = sys.argv[2:] or list(LR)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    for arch in archs:
        for version in TURNS:
            res = subprocess.run(
                [sys.executable, "-c", WORKER, src[version], arch,
                 str(LR[arch]), str(STEPS)], capture_output=True, text=True,
                timeout=900)
            if res.returncode != 0:
                raise SystemExit(f"{arch} {version}:\n{res.stderr[-3000:]}")
            out = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"arch": arch, "version": version, **out}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
