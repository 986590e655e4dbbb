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
6. block_sparse — the block-sparse (ZTB) kernel against its plain version
             at the +ZTB path's shapes (BitNet-1.58B's qkv_proj and
             out_proj per-Legion slices at S=512, the granite-moe expert
             up slice at 16 tokens; block sparsity 0 / 0.5 / 1): int8
             max_abs_err must be 0, float32 within rtol 1e-4 / atol 1e-3.
             Times the int8 kernel, the plain version and, where M > 16,
             torch._int_mm on the masked dense weights (a yardstick only).
7. ztb     — the paper's W1.58+ZTB evaluation at kernel granularity:
             Machine(dlegion(8)).cross_validate of BitNet-1.58B and
             BitNet-1.58B-KV attention (S=512, ztb_sparsity 0.5, outputs
             checked) at worst error 0, through the block-sparse kernel;
             then qkv_proj and out_proj at window granularity must give
             equal outputs and traffic.
8. zoo     — lower(zoo_spec(granite-moe-1b-a400m)) at full width through
             Machine(dlegion(), granularity="kernel"): the 24 experts the
             router skips run the block-sparse kernel; outputs must equal
             reference_outputs and the expert-skip traffic identity
             against the dense-E twin must hold exactly (skip_eq_err 0).

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
F32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 120 * 2**20      # > 2x the 50 MB L2
ZTB_SEQ_LEN = 512                 # the paper evaluates S=2048 (PERF.md §4)
ZOO_ARCH = "granite-moe-1b-a400m"


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


def device_us(fn, iters: int, kernel: str, attempts: int = 2):
    """Mean device time of ``kernel`` over ``iters`` calls, from
    torch.profiler's CUDA activity; a trace that shows none is taken again
    (``attempts`` in all), then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
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
        if count:
            return total / count
    return None


def phase_build():
    from repro_torch.kernels import build

    sources = ["bitlinear", "block_sparse"]
    t0 = time.perf_counter()
    build.build(sources)
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for _n, (_s, log) in build.BUILD_LOG.items()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "sources": [f"{n}.cu" for n in sources],
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


def block_sparse_shapes():
    """(stage, M, K, widest per-Legion N slice) of the +ZTB path: the
    ztb phase's BitNet-1.58B qkv_proj and out_proj on dlegion(8), and the
    zoo phase's granite-moe expert up stage on dlegion()."""
    from repro_torch.configs import get_config
    from repro_torch.core import dlegion
    from repro_torch.core import workloads as W
    from repro_torch.core.scheduler import plan_stage
    from repro_torch.legion import zoo_spec

    attn = W.attention_workloads(W.bitnet_1_58b(seq_len=ZTB_SEQ_LEN))
    moe = zoo_spec(get_config(ZOO_ARCH))
    _router, up, _down = W.moe_ffn_workloads(
        tokens=moe.tokens, d_model=moe.d_model, d_ff=moe.d_ff,
        n_experts=moe.n_experts, weight_bits=moe.weight_bits)
    out = []
    for wl, cfg in ((attn[0], dlegion(8)), (attn[3], dlegion(8)),
                    (up, dlegion())):
        plan = plan_stage(cfg, wl)
        out.append((wl.stage, wl.m, wl.k,
                    max(a.n_hi - a.n_lo for a in plan.assignments)))
    return out


def sparse_operands(m, k, n, sparsity, dtype, seed, bk, bn):
    """x [M, K] and w [K, N] with a ``sparsity`` share of w's (bk, bn)
    blocks zeroed, on the card, and w's block mask."""
    import numpy as np
    import torch

    from repro_torch.kernels.block_sparse import ops as bs

    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
        w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
    kt, nt = -(-k // bk), -(-n // bn)
    blocks = rng.permutation(kt * nt)[:int(round(sparsity * kt * nt))]
    keep = np.ones(kt * nt, dtype=bool)
    keep[blocks] = False
    keep = keep.reshape(kt, nt)
    w *= np.repeat(np.repeat(keep, bk, 0), bn, 1)[:k, :n].astype(w.dtype)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda(),
            bs.block_mask(w, bk=bk, bn=bn))


def block_sparse_bound(m, k, n, mask, bk, bn, dtype):
    """(bound ms, "bytes" | "operations"): the non-zero w blocks, the x
    columns they touch and the output over 3.35 TB/s, against the
    multiply-adds of the non-zero blocks over the type's peak rate."""
    import numpy as np
    import torch

    elt = 1 if dtype == torch.int8 else 4
    rows = np.minimum(np.arange(1, mask.shape[0] + 1) * bk, k) - \
        np.arange(mask.shape[0]) * bk
    cols = np.minimum(np.arange(1, mask.shape[1] + 1) * bn, n) - \
        np.arange(mask.shape[1]) * bn
    w_elems = float((mask * np.outer(rows, cols)).sum())
    x_elems = m * float(rows[mask.any(axis=1)].sum())
    nbytes = (w_elems + x_elems) * elt + m * n * 4
    ops = 2.0 * m * w_elems
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / (INT8_OPS_PER_S if elt == 1 else F32_OPS_PER_S) * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


def phase_block_sparse():
    import torch

    from repro_torch.kernels.block_sparse import ops as bs
    from repro_torch.kernels.block_sparse.ref import block_sparse_matmul_ref

    bk, bn = 128, bs.KERNEL_BN      # the Machine's blocks on dlegion
    rows = []
    for stage, m, k, n in block_sparse_shapes():
        for sparsity in (0.0, 0.5, 1.0):
            for dtype in (torch.int8, torch.float32):
                x, w, mask = sparse_operands(m, k, n, sparsity, dtype,
                                             m + k + n, bk, bn)
                idx, cnt = bs.schedule(mask, x.device)
                plain = block_sparse_matmul_ref(x, w, mask, bk=bk, bn=bn)
                fresh = bs.block_sparse_matmul(x, w, idx, cnt, bk=bk, bn=bn)
                acc = torch.zeros_like(plain)
                bs.block_sparse_matmul(x, w, idx, cnt, bk=bk, bn=bn,
                                       out=acc)
                torch.cuda.synchronize()
                if dtype == torch.int8:
                    err = max(int((fresh - plain).abs().max()),
                              int((acc - plain).abs().max()))
                    ok = err == 0
                else:
                    err = max(float((fresh - plain).abs().max()),
                              float((acc - plain).abs().max()))
                    ok = torch.allclose(fresh, plain, rtol=1e-4,
                                        atol=1e-3) and torch.allclose(
                        acc, plain, rtol=1e-4, atol=1e-3)
                if not ok:
                    raise AssertionError(
                        f"block_sparse {stage} m={m} k={k} n={n} "
                        f"sparsity={sparsity} {dtype}: max_abs_err {err}")
                row = {"stage": stage, "m": m, "k": k, "n": n,
                       "sparsity": sparsity, "dtype": str(dtype)[6:],
                       "nonzero_blocks": int(mask.sum()),
                       "blocks": int(mask.size), "max_abs_err": err}
                if dtype == torch.int8:
                    wbytes = w.numel()
                    copies = [w] + [w.clone() for _ in range(
                        min(max(L2_FLUSH_BYTES // wbytes, 1), 4000) - 1)]
                    call = lambda i: bs.block_sparse_matmul(  # noqa: E731
                        x, copies[i % len(copies)], idx, cnt, bk=bk, bn=bn,
                        out=acc)
                    row["ms"] = cuda_ms(call, 200)
                    row["device_us"] = device_us(call, 50, "block_sparse")
                    row["plain_ms"] = cuda_ms(
                        lambda i: block_sparse_matmul_ref(
                            x, copies[i % len(copies)], mask, bk=bk, bn=bn),
                        20)
                    row["library_ms"] = None
                    if m > 16:
                        wm = copies[:8]          # already masked
                        row["library_ms"] = cuda_ms(lambda i: torch._int_mm(
                            x, wm[i % len(wm)]), 50)
                    row["bound_ms"], row["bound_by"] = block_sparse_bound(
                        m, k, n, mask, bk, bn, dtype)
                    del copies
                rows.append(row)
    for r in rows:
        emit(dict(phase="block_sparse", **r))
    return rows


class StageLaunches:
    """Instrument: block-sparse launches of each program stage."""

    def __init__(self):
        self.by_stage = {}
        self._start = 0

    def on_stage_begin(self, *, stage, index, deps):
        from repro_torch.kernels.block_sparse import ops as bs
        self._start = sum(bs.LAUNCHES.values())

    def on_stage_end(self, *, stage, outputs):
        from repro_torch.kernels.block_sparse import ops as bs
        self.by_stage[stage] = sum(bs.LAUNCHES.values()) - self._start


def phase_ztb():
    import numpy as np
    import torch

    from repro_torch.core import dlegion
    from repro_torch.core import workloads as W
    from repro_torch.kernels.block_sparse import ops as bs
    from repro_torch.legion import Machine

    launches = 0
    for name in ("bitnet_1_58b", "bitnet_1_58b_kv"):
        spec = getattr(W, name)(seq_len=ZTB_SEQ_LEN)
        wls = W.attention_workloads(spec)
        machine = Machine(dlegion(8), granularity="kernel")
        bs.reset_launches()
        t0 = time.perf_counter()
        tv, cv = machine.cross_validate(wls, ztb_sparsity=0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = sum(bs.LAUNCHES.values())
        launches += n_launch
        worst = max([e for v in tv for e in v.errors.values()]
                    + [v.rel_err for v in cv])
        if not all(v.ok for v in tv + cv) or worst != 0:
            raise AssertionError(f"{spec.name} W1.58+ZTB cross_validate: "
                                 f"worst error {worst}")
        if n_launch == 0:
            raise AssertionError(f"{spec.name}: no block-sparse launch")
        emit({"phase": "ztb", "model": spec.name, "seq_len": spec.seq_len,
              "hidden": spec.hidden, "heads": spec.heads,
              "kv_heads": spec.kv_heads, "layers": spec.layers,
              "ztb_sparsity": 0.5, "stages": [w.stage for w in wls],
              "block_sparse_launches": n_launch,
              "cross_validate_worst_error": worst, "outputs_checked": True,
              "wall_seconds": wall})
    # window vs kernel granularity on the +ZTB stages of BitNet-1.58B
    wls = W.attention_workloads(W.bitnet_1_58b(seq_len=ZTB_SEQ_LEN))
    same = {}
    for wl in (wls[0], wls[3]):
        res = {}
        for gran in ("kernel", "window"):
            rep = Machine(dlegion(8), granularity=gran).run(
                wl, ztb_sparsity=0.5, check_outputs=False, validate=False)
            res[gran] = (rep.outputs, dataclasses.asdict(rep.trace.totals))
        same[wl.stage] = (np.array_equal(res["kernel"][0], res["window"][0])
                          and res["kernel"][1] == res["window"][1])
    if not all(same.values()):
        raise AssertionError(f"window vs kernel granularity: {same}")
    emit({"phase": "ztb", "window_equals_kernel": same})
    return launches


def phase_zoo():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dlegion
    from repro_torch.kernels.block_sparse import ops as bs
    from repro_torch.legion import (
        Machine, lower, moe_stage_names, reference_outputs, zoo_spec,
    )

    cfg = get_config(ZOO_ARCH)
    spec = zoo_spec(cfg)
    prog = lower(spec)
    machine = Machine(dlegion(), granularity="kernel")
    probe = machine.add_instrument(StageLaunches())
    bs.reset_launches()
    t0 = time.perf_counter()
    rep = machine.run(prog)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sum(bs.LAUNCHES.values())
    if not rep.ok:
        raise AssertionError(f"{cfg.name} zoo program: {rep}")
    ref = reference_outputs(prog)
    bad = [n for n in ref if not np.array_equal(rep.outputs[n], ref[n])]
    if bad or set(ref) != set(rep.outputs):
        raise AssertionError(f"{cfg.name}: outputs differ at {bad}")
    _chosen, skipped = spec.routing()
    cold = [n for e in skipped for n in moe_stage_names(e)
            if probe.by_stage.get(n, 0) == 0]
    if not skipped or cold:
        raise AssertionError(f"skipped experts' stages without a "
                             f"block-sparse launch: {cold}")
    machine.instruments.remove(probe)
    dense = dataclasses.replace(spec, top_k=spec.n_experts, chosen=None)
    rep_d = machine.run(lower(dense))
    if not rep_d.ok:
        raise AssertionError(f"{cfg.name} dense twin: {rep_d}")
    total = lambda r: sum(sr.traffic.weight_bytes             # noqa: E731
                          for sr in r.stage_reports.values())
    skipped_bytes = sum(rep_d.stage_reports[n].traffic.weight_bytes
                        for e in skipped for n in moe_stage_names(e))
    wk, wd = total(rep), total(rep_d)
    skip_eq_err = abs(wk - (wd - skipped_bytes)) / wd
    if skip_eq_err != 0:
        raise AssertionError(f"expert-skip identity: error {skip_eq_err}")
    emit({"phase": "zoo", "model": cfg.name, "d_model": spec.d_model,
          "n_experts": spec.n_experts, "d_ff": spec.d_ff,
          "top_k": spec.top_k, "tokens": spec.tokens,
          "stages": len(prog), "skipped_experts": len(skipped),
          "block_sparse_launches": launches, "outputs_bit_exact": True,
          "skip_eq_err": skip_eq_err, "expert_skip_savings_x": wd / wk,
          "wall_seconds": wall})
    return launches


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
    bs_rows = phase_block_sparse()
    bs_launches = {"ztb": phase_ztb(), "zoo": phase_zoo()}

    head = next(r for r in rows if r["stage"] == "mlp_up" and r["m"] == 1
                and r["bits"] == 2)
    bs_head = next(r for r in bs_rows if r["stage"] == "qkv_proj"
                   and r["sparsity"] == 0.5 and r["dtype"] == "int8")
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
    }, {
        "name": "block_sparse", "route": "cuda",
        "source": "src/repro_torch/csrc/block_sparse.cu",
        "replaces": "src/repro/kernels/block_sparse/kernel.py:63",
        "launches": sum(bs_launches.values()),
        "launches_by_phase": bs_launches,
        "max_abs_err": max(r["max_abs_err"] for r in bs_rows
                           if r["dtype"] == "int8"),
        "max_abs_err_float32": max(r["max_abs_err"] for r in bs_rows
                                   if r["dtype"] == "float32"),
        "shape": {k: bs_head[k] for k in ("stage", "m", "k", "n",
                                          "sparsity", "dtype")},
        "ms": bs_head["ms"], "plain_ms": bs_head["plain_ms"],
        "bound_ms": bs_head["bound_ms"], "bound_by": bs_head["bound_by"],
        "library_ms": bs_head["library_ms"],
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
