#!/usr/bin/env python3
"""Where the dry run's memory and the card's part: one full-size train
step of ARCH on the card under the dry run's cost counter
(``launch.hlo_cost.CostCounter``, on real CUDA tensors), with the caching
allocator read after every op.

    python3 tools/peak_probe.py [ARCH] [--compressed] [--flat]

ARCH defaults to mamba2-130m.  The step is phase ssm_train's (bf16, QAT,
the config's remat, AdamW, one 4096-token sequence), after one warm-up
step; ``--compressed`` takes phase train_compressed's step instead (a
one-rank NCCL group), and ``--flat`` remats each layer alone
(``models.common.remat_groups`` forced to 1) for a schedule's A/B.  Prints, as JSON lines: the
card's name and power limit; both peaks (the counter's live bytes and
``torch.cuda.max_memory_allocated``) and the op at each; and the ops after
which the counter's live bytes less the allocator's grew most, with
their neighbours.  Imports nothing of JAX.
"""
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]


def main() -> int:
    with contextlib.ExitStack() as stack:
        return run(stack)


def run(stack) -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, build_train_step, init_train_state
    from repro_torch.train.optimizer import tree_leaves

    from repro_torch.models import common

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    arch = args[0] if args else "mamba2-130m"
    compressed = "--compressed" in sys.argv
    if "--flat" in sys.argv:
        common.remat_groups = lambda cfg, layers: 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)

    class Probe(CostCounter):
        def __init__(self):
            super().__init__()
            self.trail = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self.trail.append((func._overloadpacket.__name__,
                               self.live_bytes,
                               torch.cuda.memory_allocated()))
            return out

    if compressed:
        from repro_torch.distributed import process_group
        from repro_torch.train.train_loop import build_compressed_train_step

        store = os.path.join(ROOT, "build", "peak_probe_store")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        if os.path.exists(store):
            os.remove(store)
        stack.enter_context(process_group(store, 0, 1))
    cfg = get_config(arch)
    api = build_model(cfg)
    opt = AdamW(lr=1e-4)
    gen = torch.Generator(device=api.device)
    gen.manual_seed(0)
    state = init_train_state(api, opt, gen, compressed=compressed)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        cfg, batch=1, seq=4096, step=0).items()}
    step = (build_compressed_train_step if compressed
            else build_train_step)(api, opt)
    # the step is handed the last reference to the state (phase
    # train_compressed's box), so what it frees is freed
    box = [state]
    del state
    box.append(step(box.pop(), batch)[0])
    torch.cuda.synchronize()
    probe = Probe()
    probe.track_external(tree_leaves(box[0]) + list(batch.values()))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with probe:
        box.append(step(box.pop(), batch)[0])
    torch.cuda.synchronize()
    trail = probe.trail
    i_c = max(range(len(trail)), key=lambda i: trail[i][1])
    i_a = max(range(len(trail)), key=lambda i: trail[i][2])
    print(json.dumps({
        "arch": arch, "compressed": compressed,
        "remat_groups": common.remat_groups(cfg, cfg.layers),
        "ops": len(trail), "counter_peak": probe.peak_bytes,
        "counter_peak_at": [i_c, trail[i_c][0]],
        "allocator_peak": torch.cuda.max_memory_allocated(),
        "allocator_live_before": base,
        "allocator_max_after_an_op": [i_a, trail[i_a][0], trail[i_a][2]]}),
        flush=True)
    gaps = [t[1] - t[2] for t in trail]
    jumps = sorted(range(1, len(trail)),
                   key=lambda i: -(gaps[i] - gaps[i - 1]))[:12]
    for i in sorted(jumps):
        print(json.dumps({"i": i, "op": trail[i][0],
                          "gap_growth": gaps[i] - gaps[i - 1],
                          "gap": gaps[i], "counter": trail[i][1],
                          "allocator": trail[i][2],
                          "before": [t[0] for t in trail[i - 3:i]],
                          "after": [t[0] for t in trail[i + 1:i + 4]]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
