#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every CUDA source of src/repro_torch/csrc with nvcc
             (sm_90a), all at once.
2. kernel  — the bitlinear kernel against its plain PyTorch version at the
             serve path's shapes (decode M=1 and prefill M=24; the four
             projection families' per-Legion slices; bits 2/4/8):
             max_abs_err must be 0 (exact int32).  Times the kernel, the
             plain version and, where M > 16, torch._int_mm on the unpacked
             weights (a yardstick only); weights rotate through copies that
             exceed the 50 MB L2, as the serve path reads each tile once.
3. model   — a reduced float32 model without quantization on the card
             against the same model on the CPU (prefill + decode logits).
4. serve   — full BitNet-1.58B (32 layers, full width, bf16, random weights
             from a seeded torch.Generator) through ServeEngine with a
             LegionServeBackend at kernel granularity: 8 requests, launch
             counts taken around the run; every request must finish and
             backend.cross_validate must be ok with worst error 0.
5. window  — one decode step (m=1, context 16) at window granularity:
             outputs and tallies must equal kernel granularity.

Then a ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises; without a CUDA card, or run outside a checkout
of the repository, the script exits non-zero before printing a result.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12          # H100 SXM dense int8 tensor-core peak
L2_FLUSH_BYTES = 120 * 2**20      # > 2x the 50 MB L2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_us(fn, iters: int, kernel: str):
    """Mean device time of ``kernel`` over ``iters`` calls, from
    torch.profiler's CUDA activity (None if the trace shows none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += evt.device_time_total
            count += evt.count
    return total / count if count else None


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["bitlinear"])
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for _n, (_s, log) in build.BUILD_LOG.items()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "sources": ["bitlinear.cu"],
          "seconds": seconds, "ptxas": ptxas})


def serve_shapes():
    """(family, K, per-Legion N slice) of the four projection families at
    full width, from the scheduler's own plans on dlegion(8)."""
    from repro_torch.configs import get_config
    from repro_torch.core import dlegion
    from repro_torch.core import workloads as W
    from repro_torch.core.scheduler import plan_stage

    cfg = get_config("bitnet-1.58b")
    hd = cfg.head_dim_
    fams = (
        (W.QKV_PROJ, cfg.d_model, hd, cfg.n_heads + 2 * cfg.kv_heads,
         W.HEAD_PER_UNIT),
        (W.OUT_PROJ, cfg.n_heads * hd, cfg.d_model, 1, W.N_PARTITION),
        (W.MLP_UP, cfg.d_model, cfg.d_ff, 2, W.N_PARTITION),
        (W.MLP_DOWN, cfg.d_ff, cfg.d_model, 1, W.N_PARTITION),
    )
    out = []
    for stage, k, n, count, mapping in fams:
        wl = W.GEMMWorkload(stage=stage, m=1, k=k, n=n, weight_bits=2,
                            count=count, shared_input=count > 1,
                            mapping=mapping)
        plan = plan_stage(dlegion(8), wl)
        out.append((stage, k, max(a.n_hi - a.n_lo for a in plan.assignments)))
    return out


def phase_kernel():
    import numpy as np
    import torch

    from repro_torch.kernels.bitlinear import ops
    from repro_torch.kernels.bitlinear.ref import (
        bitlinear_matmul_ref, unpack_weights,
    )
    from repro_torch.quant.packing import pack_2bit_kmajor, pack_4bit_kmajor

    pack = {2: pack_2bit_kmajor, 4: pack_4bit_kmajor, 8: lambda w: w}
    lohi = {2: (-2, 2), 4: (-8, 8), 8: (-128, 128)}
    rows = []
    for stage, k, n in serve_shapes():
        for m in (1, 24):
            for bits in (2, 4, 8):
                rng = np.random.default_rng(k * 7 + n + m + bits)
                x = torch.from_numpy(rng.integers(
                    -128, 128, size=(m, k)).astype(np.int8)).cuda()
                w = pack[bits](torch.from_numpy(rng.integers(
                    *lohi[bits], size=(k, n)).astype(np.int8)).cuda())
                acc = torch.zeros((m, n), dtype=torch.int32, device="cuda")
                ops.tile_gemm(x, w, bits=bits, out=acc)
                fresh = ops.tile_gemm(x, w, bits=bits)
                plain = bitlinear_matmul_ref(x, w, bits=bits)
                torch.cuda.synchronize()
                err = max(int((acc - plain).abs().max()),
                          int((fresh - plain).abs().max()))
                if err:
                    raise AssertionError(
                        f"bitlinear {stage} m={m} k={k} n={n} bits={bits}: "
                        f"max_abs_err {err}")
                wbytes = w.numel() * w.element_size()
                copies = [w] + [w.clone() for _ in range(
                    min(max(L2_FLUSH_BYTES // wbytes, 1), 4000) - 1)]
                call = lambda i: ops.tile_gemm(          # noqa: E731
                    x, copies[i % len(copies)], bits=bits, out=acc)
                ms = cuda_ms(call, 200)
                kernel_us = device_us(call, 50, "bitlinear_kernel")
                plain_ms = cuda_ms(lambda i: bitlinear_matmul_ref(
                    x, copies[i % len(copies)], bits=bits), 20)
                library_ms = None
                if m > 16:
                    wu = [unpack_weights(c, bits).contiguous()
                          for c in copies[:8]]
                    library_ms = cuda_ms(lambda i: torch._int_mm(
                        x, wu[i % len(wu)]), 50)
                nbytes = m * k + wbytes + m * n * 4
                byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
                op_ms = 2.0 * m * n * k / INT8_OPS_PER_S * 1e3
                rows.append({
                    "stage": stage, "m": m, "k": k, "n": n, "bits": bits,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "device_us": kernel_us,
                    "library_ms": library_ms,
                    "bound_ms": max(byte_ms, op_ms),
                    "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                })
                del copies
    for r in rows:
        emit(dict(phase="kernel", **r))
    return rows


def phase_model():
    """The model math on the card against the CPU: a reduced float32
    model without activation quantization, whose rounding would turn
    float32 ulps into whole quantization steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg)
    p_cpu = cpu.init(0)
    p_gpu = params_from_jax(_numpy_tree(p_cpu))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, size=(2, 11)))
    worst = 0.0
    lc, cc = cpu.prefill(p_cpu, {"tokens": toks}, cpu.init_cache(2, 32))
    lg, cg = gpu.prefill(p_gpu, {"tokens": toks.cuda()},
                         gpu.init_cache(2, 32))
    pos = torch.tensor([11, 11])
    for step in range(3):
        if not torch.isfinite(lg).all() or tuple(lg.shape) != (2, 1,
                                                              cfg.vocab):
            raise AssertionError(f"bad logits {tuple(lg.shape)}")
        worst = max(worst, float((lg.cpu() - lc).abs().max()),
                    float((cg.k.cpu() - cc.k).abs().max()))
        tok = torch.argmax(lc[:, -1], dim=-1)
        lc, cc = cpu.decode(p_cpu, tok, cc, pos)
        lg, cg = gpu.decode(p_gpu, tok.cuda(), cg, pos.cuda())
        pos = pos + 1
    # float32 on both, summed in other orders: 1e-4 absolute on logits of
    # magnitude ~1
    if worst > 1e-4:
        raise AssertionError(f"card vs CPU model: max abs diff {worst}")
    emit({"phase": "model", "config": cfg.name, "dtype": "float32",
          "max_abs_diff_vs_cpu": worst, "tolerance": 1e-4})


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dlegion
    from repro_torch.kernels.bitlinear import ops
    from repro_torch.models import build_model
    from repro_torch.serve import LegionServeBackend, ServeEngine
    from repro_torch.serve.engine import prepare_params

    cfg = get_config("bitnet-1.58b")
    api = build_model(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device=api.device)
    gen.manual_seed(0)
    params = prepare_params(api.init(gen))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServeEngine(api, params, max_slots=4, max_seq=256)
    backend = LegionServeBackend(dlegion(8), cfg, params,
                                 granularity="kernel").attach(eng)
    # time the backend's share of each step (the model forward is the rest)
    backend_s = [0.0]
    on_step = eng.step_observers.pop()

    def timed(event):
        t = time.perf_counter()
        on_step(event)
        backend_s[0] += time.perf_counter() - t
    eng.step_observers.append(timed)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=rng.integers(4, 24)),
                       max_new_tokens=16) for _ in range(8)]
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        if len(r.output) != 16 or not all(0 <= t < cfg.vocab
                                          for t in r.output):
            raise AssertionError(f"request {r.uid}: output {r.output}")
    if sum(launches.values()) == 0:
        raise AssertionError("the serve path launched no bitlinear kernel")
    tv, cv = backend.cross_validate(m=1, contexts=(16,))
    worst = max([e for v in tv for e in v.errors.values()]
                + [v.rel_err for v in cv])
    if not all(v.ok for v in tv + cv) or worst != 0:
        raise AssertionError(f"cross_validate: worst error {worst}")
    s = backend.summary()
    tokens = sum(len(r.output) for r in done)
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": n_params,
          "setup_seconds": setup_s, "requests": len(done),
          "tokens": tokens,
          "prompt_tokens": int(sum(len(r.prompt) for r in done)),
          "wall_seconds": wall, "tokens_per_s": tokens / wall,
          "legion_backend_seconds": backend_s[0],
          "prefill_steps": s["prefill_steps"],
          "decode_steps": s["decode_steps"], "cycles": s["cycles"],
          "weight_bytes": s["weight_bytes"], "act_bytes": s["act_bytes"],
          "psum_bytes": s["psum_bytes"],
          "bitlinear_launches_by_bits": launches,
          "cross_validate_worst_error": worst,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return cfg, params, backend, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_window(cfg, params, kernel_backend):
    import numpy as np

    from repro_torch.core import dlegion
    from repro_torch.kernels.bitlinear import ops
    from repro_torch.serve import LegionServeBackend

    per_step = {}
    tallies = {}
    outputs = {}
    for gran in ("kernel", "window"):
        backend = LegionServeBackend(dlegion(8), cfg, params,
                                     granularity=gran)
        ops.reset_launches()
        tallies[gran] = dataclasses.asdict(backend.step_tally(1, (16,)))
        per_step[gran] = sum(ops.LAUNCHES.values())
        outputs[gran] = backend.machine.run(backend.step_program(1, (16,)),
                                            validate=False).outputs
    same_tally = tallies["window"] == tallies["kernel"] == \
        dataclasses.asdict(kernel_backend.step_tally(1, (16,)))
    same_out = outputs["kernel"].keys() == outputs["window"].keys() and all(
        np.array_equal(outputs["kernel"][k], outputs["window"][k])
        for k in outputs["kernel"])
    if not (same_tally and same_out):
        raise AssertionError(f"window vs kernel granularity: tallies equal "
                             f"{same_tally}, outputs equal {same_out}")
    emit({"phase": "window", "m": 1, "context": 16,
          "launches_per_decode_step": per_step, "tallies_equal": True,
          "outputs_equal": True, "stages": len(outputs["kernel"])})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    phase_build()
    rows = phase_kernel()
    phase_model()
    cfg, params, backend, launches = phase_serve()
    phase_window(cfg, params, backend)

    head = next(r for r in rows if r["stage"] == "mlp_up" and r["m"] == 1
                and r["bits"] == 2)
    emit({"kernels": [{
        "name": "bitlinear", "route": "cuda",
        "source": "src/repro_torch/csrc/bitlinear.cu",
        "replaces": "src/repro/kernels/bitlinear/kernel.py:75",
        "launches": sum(launches.values()),
        "launches_by_bits": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "shape": {k: head[k] for k in ("stage", "m", "k", "n", "bits")},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
