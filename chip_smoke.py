#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every CUDA source of src/repro_torch/csrc with nvcc
             (sm_90a), all at once.
2. kernel  — the bitlinear kernel against its plain PyTorch version at the
             serve path's shapes (decode M=1 and prefill M=24; the four
             projection families' per-Legion slices; bits 2/4/8), then as
             the Machine launches it, once per stage run: every projection
             stage of BitNet-1.58B at M=1 and 24 (a grouped launch over the
             plan_stage(dlegion(8)) assignments) and the two attention
             stages at contexts 16 and 256 (bits 8): max_abs_err must be 0
             (exact int32) and a stage must take one launch.  Times the
             kernel, the plain version and, where M > 16, torch._int_mm on
             the unpacked weights (a yardstick only); weights rotate
             through copies that exceed the 50 MB L2 (at most 32 copies of
             a stage), as the serve path reads each tile once.
3. model   — a reduced float32 model without quantization on the card
             against the same model on the CPU (prefill + decode logits).
4. serve   — full BitNet-1.58B (32 layers, full width, bf16, random weights
             from a seeded torch.Generator) through ServeEngine with a
             LegionServeBackend at kernel granularity: 8 requests of
             SERVE_NEW_TOKENS, launch counts taken around the run; every request must finish and
             backend.cross_validate must be ok with worst error 0.
5. window  — one decode step (m=1, context 16) at window granularity:
             outputs and tallies must equal kernel granularity, which must
             launch the bitlinear kernel once per integer stage.
5a. sharded — the same decode step and a 4-token prompt's prefill step
             through LegionServeBackend(dlegion(8), window granularity,
             executor=ShardedExecutor()): outputs bit for bit and tallies
             exactly equal to the in-process window backend's, one device
             used, exactly one bitlinear launch at bits 8 per stage run
             per shard; then 2 prompts x 8 tokens through one ServeEngine
             priced by a sharded and an in-process window backend at once,
             their tallies equal.  Seconds per step of both.
5b. serve_load — the same full BitNet-1.58B params served in-flight
             (64-token prefill chunks merged with the decode batch), paged
             (16 pages of 16 tokens: one max_seq=256 window, so requests
             are preempted and re-prefilled) and admission-gated
             (LiveAdmission at the card's memory) under a lognormal trace
             of 8 requests replayed by obs.run_load, priced by a
             LegionServeBackend(page_tokens=16) at kernel granularity:
             every request completes, none is refused, >= 1 preemption,
             bitlinear launches at bits 2 and 8, cross_validate(m=1,
             context 256) worst error 0 with the page channel equal to
             simulate(); one recorded merged step (chunks + decode) makes
             one bitlinear launch per integer stage, and again under a
             PipelinedExecutor with a TimelineTracer and a RooflineTracer
             (serial and overlapped cycles equal the report's, page cells
             present, every roofline efficiency <= 1; Chrome JSON in
             build/); a 128-token prompt prefilled as 64 + 64 in bf16
             within CHUNK_BF16_ATOL of the whole prefill; and reduced
             BitNet-1.58B (float32, no quantization) through the same
             engine on the card and on the CPU: equal tokens, step_log,
             page tables, preemptions and backend tallies, last-chunk
             logits within 1e-4.
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

9. ssd      — the SSD scan kernel against its plain version (chunked, on
             the card) with the terminal state, at Zamba2-7B's prefill
             shapes (112 heads, N = P = 64; S = 4096 at chunk 128, and a
             23-token prompt as one 23-step chunk; dta and dtx as
             transposed [B, S, H, ...] views and B and C shared by the
             heads as a stride-0 view, as the model passes them) and
             Mamba2-130m's (24 heads, N = 128, P = 64, S = 1024): outputs
             and state within rtol / atol 1e-4 (float32 summed in another
             order).  Times the kernel, the plain version, the bound.
9b. ssd_bwd — the SSD backward kernels (csrc/ssd_bwd.cu) against the
             plain backward (ssd_chunked_bwd_ref, on the card) from the
             forward kernel's own scratch, B and C [B, S, N] shared by the
             heads: Zamba2-7B's train shape (112 heads, N = P = 64,
             S = 4096, chunk 128), Mamba2-130m's (24 heads, N = 128), and a
             1000-token Zamba2 prompt (a short last chunk) with the
             terminal state's gradient: every gradient within rtol 1e-4 /
             atol 1e-5 x max|g|, two calls bit-equal, and ssd() under
             autograd launching the backward once with the same bits.
             Times the backward, its device time (and each of its four
             kernels'), the plain backward, the bounds (3xTF32 on the
             tensor cores, the kernel's path, and float32 on the CUDA
             cores; no single PyTorch call computes it: library_ms null).
10. flash   — the flash-attention kernel against its plain version at
             Zamba2-7B's long-prompt prefill (B = 1, H = Hkv = 32,
             S = 4096, d = 112, causal, bf16 against the plain version in
             float32 within rtol 8e-3 / atol 2e-5; q, k, v as the
             [B, S, H, d] views the model passes), the same in float32 at
             S = 1024 (rtol 2e-4 / atol 2e-5) and a GQA case (H = 32,
             Hkv = 8, d = 128, float32, S = 1024).  Times the kernel, the
             plain version and scaled_dot_product_attention (a yardstick
             only: the port never calls it).  Every row is the serve
             path's launch, with a null lse pointer (no lse launch counted).
11. hybrid_model — reduced Zamba2 and Mamba2 (float32, no quantization) on
             the card against the CPU: a 3072-token prefill (the flash
             path) and 3 decode steps, logits within 1e-4.
12. hybrid_serve — full Zamba2-7B (81 layers, d_model 3584, bf16, random
             weights from a seeded torch.Generator) through ServeEngine
             (4 slots, max_seq 4352): two 4096-token and two short
             prompts, 16 new tokens each; launch counts taken around the
             run must be exactly 324 SSD (81 blocks x 4 prefills) and 28
             flash (14 shared-attention applications x 2 long prompts).
             Then one 4096-token prefill again under torch.profiler: the
             device time of every kernel and of the SSD and flash kernels.
             (Phase 10 also holds the flash kernel, bf16 against the
             float32 plain version, at the long prefills of the three
             families below: granite-moe-3b-a800m H 24 / Hkv 8, d 64,
             causal; hubert-xlarge H = Hkv = 16, d 80, non-causal;
             internvl2-76b H 64 / Hkv 8, d 128, causal; S = 4096.)
13. moe_serve — full granite-moe-3b-a800m (32 layers, d_model 1536, 40
             experts padded to 48, top-8, bf16, random weights from a
             seeded torch.Generator) through ServeEngine (4 slots, max_seq
             4352): prompts of 4096, 23, 4096 and 16 tokens x 16 tokens;
             exactly 64 flash launches (32 layers x 2 long prompts), every
             request finished; then the same params in-flight (64-token
             chunks) on 4 prompts of 40-200 tokens x 8 tokens.
14. encoder — full hubert-xlarge (48 layers, d_model 1280, 16 heads of
             d = 80, bf16): train_logits and prefill on 4096 frames in the
             config's type, exactly 48 (non-causal) flash launches each;
             a changed last frame moves frame 0's logits; ServeEngine
             refuses the encoder-only model.
15. vlm     — internvl2-76b at full width, 8 of its 80 layers (d_model
             8192, GQA 64 / 8, d = 128, d_ff 28672, bf16): a prefill of 256
             patch embeddings + 3840 text tokens (exactly 8 flash
             launches), 8 decode steps, logits over 4096 positions and a
             finite loss over the last 3840.
16. families_model — reduced granite-moe-3b-a800m (experts padded to 12),
             hubert-xlarge and internvl2-76b (float32, no quantization) on
             the card against the CPU: the MoE's routed experts of every
             layer equal but at near-ties (k-th and (k+1)-th router
             probabilities within 1e-5 on the CPU), its logits within 1e-4
             where all agree (64-token prefill, 3 decode steps); the
             encoder at 3072 frames (float32 flash kernel, non-causal) and
             the VLM at 256 patches + 2816 tokens, logits within 1e-4.

10b. flash_bwd — the flash backward kernels (csrc/flash_attention_bwd.cu:
             D = rowsum(dout * out), dk / dv per 64-key tile, dq per
             64-query tile; three launches a call) against the plain
             backward (attention_bwd_ref) and against autograd through the
             plain forward, on the same values, from the forward kernel's
             lse (held to the plain lse at rtol 2e-4 / atol 2e-5): the
             BitNet-1.58B train shape (H = Hkv = 16, d = 128, S = 4096,
             causal, bf16; and float32 at S = 1024), GQA 32 / 8 at d = 128
             and the served families' d = 64 (granite-moe-3b, 24 / 8), 80
             (hubert, non-causal) and 112 (zamba2-7b), S = 4096 bf16.
             float32 within rtol 2e-3 / atol 2e-4, bf16 within 2e-2 / 2e-2
             (the JAX package's custom-VJP and bf16 flash tests); two calls
             equal bit for bit.  Times the kernels, their device time, the
             plain backward and SDPA's backward (forward + backward less
             the forward; a yardstick only).
10c. flash_offset — the flash kernels with a query offset: the
             BitNet-1.58B train shape (16 / 16 heads x d 128, S 4096,
             bf16, causal), a GQA 32 / 8 row and a d 64 row (24 / 8), each
             cut into 4 query shards of 1024 at offsets 0, 1024, 2048,
             3072 against the whole K / V: each shard's output, lse, dq,
             dk and dv against the plain versions at its offset (phase
             10's and 10b's tolerances, with the c x rms atol); the joined
             shards' output, lse and dq bit-equal to the whole-sequence
             kernels' (1024 is a multiple of every query tile), dk and dv
             summed over the shards within the bf16 tolerance and within
             the shards' own roundings; exact launch counts.  Times the
             4 shard calls, the whole call, the plain versions and SDPA
             with each shard's boolean offset mask (a yardstick only; the
             backend SDPA picked is printed).
17. train_model — reduced BitNet (float32, no quantization, 3072-token
             sequences, so every layer's attention takes the flash path and
             its backward the kernels) on the card against the CPU from the
             same state: the loss within rel 1e-5 and every gradient leaf
             within rtol 1e-4 / atol 1e-5 * max|g|, then 2 train steps, loss
             within rel 1e-5; then TrainingRunner on the card with a
             Checkpointer under build/: a crash injected at step 3 resumes
             from the checkpoint at step 2 and ends at step 6 equal bit for
             bit to an uninterrupted run, and a save then restore is
             bit-exact.
18. train   — full-width BitNet-1.58B (32 layers, d_model 2560, bf16,
             fake-quant with straight-through estimators, JAX's two-level
             remat: 4 groups of 8 layers; random weights from a seeded
             torch.Generator) trains 4 AdamW steps (lr TRAIN_LR) on one
             4096-token sequence: finite losses and gradient norms, the last
             loss below the first, and exactly 384 flash forward launches
             with the lse (each of 32 layers 3 times a step: the step's, its
             group's recomputation, its own) and 128 backward calls;
             per-step seconds, tokens/s, peak memory, and one more step
             traced by torch.profiler (device idle share, top device
             kernels), then one counted by FlopCounterMode.

18b. ssm_train_model — reduced Mamba2-130m and Zamba2-7B (float32, no
             quantization, 3072-token sequences, so Zamba2's attention takes
             the flash path) on the card against the CPU from the same
             state: loss within rel 1e-5, every gradient leaf within rtol
             1e-4 / atol 1e-5 * max|g|, then 2 train steps, losses within
             rel 1e-5; exact SSD and flash launch counts (ssm_launches).
18c. ssm_train — Mamba2-130m at full size and Zamba2-7B at full width cut
             to SSM_TRAIN_ZAMBA2_LAYERS = 12 of its 81 layers (bf16,
             fake-quant with STE; Mamba2-130m's 24 layers in JAX's
             two-level remat, 4 groups of 6, Zamba2's periods remat'd
             whole, as in JAX; random weights from a seeded
             torch.Generator) train 4 AdamW steps (SSM_TRAIN_LR) on one
             4096-token sequence: finite losses, each below the one
             before; per step 3 SSD forward launches a Mamba2 layer, 2 a
             layer of a remat'd Zamba2 period (its last period is not
             remat'd, as in JAX: one), and one backward, flash as in
             train; per-step seconds, tokens/s, peak memory, one more step
             traced, one counted by FlopCounterMode.
18d. launch — the dry run (repro_torch.launch.dryrun, fake tensors, no
             kernel runs; its traces run in processes of their own beside
             the phases from 5b serve_load on): its one-card predictions
             of phase train's and phase ssm_train's mamba2-130m steps (the
             SSD kernels' custom ops, forward and backward) against their
             measured peaks
             (within LAUNCH_PEAK_RTOL) and FlopCounterMode's FLOPs
             (exactly); reduced cells fake against real; one arch per
             family at full width, LAUNCH_MAX_LAYERS layers, on the
             production meshes; qwen3-1.7b train_4k at full depth.
18e. examples — the four example drivers of repro_torch.examples on the
             card as a user runs them: sparsity_dse; quickstart whole (its
             14 sections; the bitlinear and block-sparse kernels in
             sections 2 and 3); train_bitnet at its 100M size, 10 steps
             with a checkpoint at step 10, then a restart to step 20 that
             resumes there; serve_bitnet --full-size (BitNet-1.58B through
             LegionServeBackend(dlegion(8)), 4 requests of 8 new tokens,
             cross_validate asserted); exact kernel launches recorded.

19. dist    — a one-rank NCCL group on the card (NCCL refuses two ranks
             on one device; the multi-rank paths are held to the JAX
             package on the CPU in gloo worlds): compressed_psum_pod on one
             layer's BitNet-1.58B gradient leaves equal bit for bit to the
             CPU's one-rank gloo result; gpipe with one stage equal to the
             sequential run; BitNet-1.58B's train-shape attention through
             _sdpa under make_rules(mesh(model=1), train_4k) goes through
             _context_parallel_flash and equals the plain flash path,
             values and gradients bit for bit.
20. train_compressed — full-width BitNet-1.58B through
             build_compressed_train_step in that group (int8 gradient
             exchange with error feedback) for 4 steps at 1 x 4096, lr
             TRAIN_LR: finite losses, the last below the first, ef non-zero
             after step 1, 384 + 128 flash launches, peak memory; then
             reduced BitNet (float32) through the compressed step on the
             card against the CPU, losses within rel 1e-5.

Then a ``kernels`` JSON line, the card's name and power limit as
nvidia-smi gives them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises; without a CUDA card, or run outside a checkout
of the repository, the script exits non-zero before printing a result.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12          # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 120 * 2**20      # > 2x the 50 MB L2
ZTB_SEQ_LEN = 512                 # the paper evaluates S=2048 (PERF.md §4)
# bf16 chunked (64 + 64) against whole prefill of a 128-token prompt at full
# width: both round every product to bf16 on GEMMs of other shapes, so the
# last logits (std ~1) differ by rounding noise (0.035-0.055 on the CPU at
# 2-8 layers); a chunk attending from the wrong offset moves them by 5-6
# (PERF.md §6, PR 16)
CHUNK_BF16_ATOL = 0.5
ZOO_ARCH = "granite-moe-1b-a400m"
# AdamW's learning rate for full-width BitNet-1.58B on one repeated 4096-token
# sequence: its first steps move every weight by about lr in a direction
# shared across the sequence; at 1e-4 and above the loss rose and
# oscillated for 4-6 steps, at 3e-5 it fell every step (tools/train_probe.py
# lr; PERF.md §6)
TRAIN_LR = 3e-5


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


def kernel_name(key: str) -> str:
    """The function name in a profiler kernel key: return type, namespaces,
    template arguments and parameters dropped."""
    head = key.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else ""


def on_card(evt) -> bool:
    """Whether a profiler event is work the card ran (a kernel, copy or
    fill), not the card-side copy of a ``record_function`` span, which
    covers the kernels launched inside it (the train step's spans,
    ``repro_torch.obs.spans``)."""
    from torch.autograd import DeviceType

    return (evt.device_type == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def device_us_by_kernel(fn, iters: int, kernels, per_call: int = 1,
                        attempts: int = 3):
    """Device time per call of each kernel named in ``kernels`` (one
    function name or several, matched exactly, so that no other kernel
    whose name holds the same letters counts), from torch.profiler's CUDA
    activity over ``iters`` calls: {name: µs}.  A call may launch several
    kernels (``per_call``, as the SSD scan's three); a trace that lacks
    any of the ``iters * per_call`` events is taken again (``attempts`` in
    all), then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = [kernels] if isinstance(kernels, str) else list(kernels)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        total, count = dict.fromkeys(names, 0.0), 0
        for evt in prof.key_averages():
            name = kernel_name(evt.key)
            if name in total:
                total[name] += evt.device_time_total
                count += evt.count
        if count == iters * per_call:
            return {k: v / iters for k, v in total.items()}
    return None


def device_us(fn, iters: int, kernels, per_call: int = 1,
              attempts: int = 3):
    """The sum of :func:`device_us_by_kernel`'s times: µs per call, or
    None."""
    by_kernel = device_us_by_kernel(fn, iters, kernels, per_call, attempts)
    return None if by_kernel is None else sum(by_kernel.values())


def all_device_us(fn, iters: int, attempts: int = 3):
    """Device time per call of everything ``iters`` calls of ``fn`` ran on
    the card (kernels, copies and fills), from torch.profiler's CUDA
    activity: the yardstick of a PyTorch call whose kernels the port does
    not name.  A trace that holds none is taken again (``attempts`` in
    all), then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        total = sum(evt.time_range.elapsed_us() for evt in prof.events()
                    if on_card(evt))
        if total:
            return total / iters
    return None


# every source of src/repro_torch/csrc, each built by its own nvcc
SOURCES = ("bitlinear", "block_sparse", "ssd", "ssd_bwd", "flash_attention",
           "flash_attention_bwd")


def phase_build():
    from repro_torch.kernels import build

    sources = list(SOURCES)
    t0 = time.perf_counter()
    build.build(sources)
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for _n, (_s, log) in build.BUILD_LOG.items()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "sources": [f"{n}.cu" for n in sources],
          "seconds": seconds, "ptxas": ptxas})


def serve_workloads(m: int):
    """BitNet-1.58B's four projection families at full width and ``m``
    rows, as the Legion serve backend builds them (2-bit weights)."""
    from repro_torch.configs import get_config
    from repro_torch.core import workloads as W

    cfg = get_config("bitnet-1.58b")
    hd = cfg.head_dim_
    fams = (
        (W.QKV_PROJ, cfg.d_model, hd, cfg.n_heads + 2 * cfg.kv_heads,
         W.HEAD_PER_UNIT),
        (W.OUT_PROJ, cfg.n_heads * hd, cfg.d_model, 1, W.N_PARTITION),
        (W.MLP_UP, cfg.d_model, cfg.d_ff, 2, W.N_PARTITION),
        (W.MLP_DOWN, cfg.d_ff, cfg.d_model, 1, W.N_PARTITION),
    )
    return [W.GEMMWorkload(stage=stage, m=m, k=k, n=n, weight_bits=2,
                           count=count, shared_input=count > 1,
                           mapping=mapping)
            for stage, k, n, count, mapping in fams]


def attention_workloads(context: int):
    """BitNet-1.58B's two act-to-act stages of one decode row at a KV
    context (bits 8)."""
    from repro_torch.configs import get_config
    from repro_torch.core import workloads as W

    cfg = get_config("bitnet-1.58b")
    return W.decode_attention_workloads(
        heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim_,
        context=context, m=1)


def serve_shapes():
    """(family, K, per-Legion N slice) of the four projection families at
    full width, from the scheduler's own plans on dlegion(8)."""
    from repro_torch.core import dlegion
    from repro_torch.core.scheduler import plan_stage

    out = []
    for wl in serve_workloads(1):
        plan = plan_stage(dlegion(8), wl)
        out.append((wl.stage, wl.k,
                    max(a.n_hi - a.n_lo for a in plan.assignments)))
    return out


def stage_group(wl, seed: int, copies: int):
    """One Legion stage run as the Machine hands it to the grouped kernel:
    the plan of ``wl`` on dlegion(8) as (instance, n_lo, n_hi) slices,
    random int8 activations (shared or per instance), ``copies`` copies of
    random weights (packed at bits 2 and 4; several, so that timed calls
    can read them cold) and an int32 accumulator, on the card.  Returns
    (x, weight copies, accumulator, slices, bytes the stage must move)."""
    import numpy as np
    import torch

    from repro_torch.core import dlegion
    from repro_torch.core.scheduler import plan_stage
    from repro_torch.quant.packing import pack_2bit_kmajor, pack_4bit_kmajor

    bits = wl.weight_bits
    pack = {2: pack_2bit_kmajor, 4: pack_4bit_kmajor, 8: lambda w: w}[bits]
    lohi = {2: (-1, 2), 4: (-8, 8), 8: (-8, 9)}[bits]
    plan = plan_stage(dlegion(8), wl)
    rng = np.random.default_rng(seed)
    xshape = (wl.m, wl.k) if wl.shared_input else (wl.count, wl.m, wl.k)
    x = torch.from_numpy(rng.integers(-128, 128, size=xshape)
                         .astype(np.int8)).cuda()
    w = torch.from_numpy(rng.integers(*lohi, size=(wl.count, wl.k, wl.n))
                         .astype(np.int8)).cuda()
    packed = [torch.stack([pack(wi) for wi in w])]
    packed += [packed[0].clone() for _ in range(copies - 1)]
    acc = torch.zeros((wl.count, wl.m, wl.n), dtype=torch.int32,
                      device=x.device)
    slices = [(a.instance, a.n_lo, a.n_hi) for a in plan.assignments]
    nbytes = (x.numel() + packed[0].numel() * packed[0].element_size()
              + acc.numel() * 4)
    return x, packed, acc, slices, nbytes


def grouped_rows():
    """The grouped kernel on whole stage runs: every projection stage of
    BitNet-1.58B at decode (m = 1) and prefill (m = 24) and the two
    attention stages at contexts 16 and 256, each one launch against its
    plain version (max_abs_err must be 0), timed, with its bound."""
    import torch

    from repro_torch.kernels.bitlinear import ops
    from repro_torch.kernels.bitlinear.ref import (
        grouped_tile_gemm_ref, unpack_weights,
    )

    stages = [(wl, None) for m in (1, 24) for wl in serve_workloads(m)]
    stages += [(wl, t) for t in (16, 256) for wl in attention_workloads(t)]
    rows = []
    for i, (wl, context) in enumerate(stages):
        wbytes = wl.count * wl.k * wl.n * wl.weight_bits // 8
        copies = min(max(L2_FLUSH_BYTES // wbytes, 1), 32)
        x, packed, acc, slices, nbytes = stage_group(wl, i, copies)
        bits = wl.weight_bits
        before = ops.LAUNCHES[bits]
        ops.grouped_tile_gemm(x, packed[0], acc, slices, bits=bits)
        launches = ops.LAUNCHES[bits] - before
        plain = torch.zeros_like(acc)
        grouped_tile_gemm_ref(x, packed[0], plain, slices, bits=bits)
        torch.cuda.synchronize()
        err = int((acc - plain).abs().max())
        if err or launches != 1:
            raise AssertionError(f"grouped {wl.stage} m={wl.m}: "
                                 f"max_abs_err {err}, {launches} launches")
        call = lambda j: ops.grouped_tile_gemm(       # noqa: E731
            x, packed[j % len(packed)], acc, slices, bits=bits)
        ops_ms = 2.0 * wl.count * wl.m * wl.k * wl.n / INT8_OPS_PER_S * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        library_ms = None
        if wl.m > 16 and (wl.shared_input or wl.count == 1):
            # one _int_mm on the unpacked weights, the instances side by
            # side along N (they share x); rotated copies, held to the plain
            wu = torch.cat([unpack_weights(w, bits) for w in packed[0]], 1)
            ucopies = [wu] + [wu.clone() for _ in range(
                min(max(L2_FLUSH_BYTES // wu.numel(), 1), 32) - 1)]
            x2 = x.reshape(wl.m, wl.k)
            lib = torch._int_mm(x2, wu).reshape(wl.m, wl.count, wl.n)
            if not torch.equal(lib.transpose(0, 1), plain):
                raise AssertionError(f"_int_mm {wl.stage} m={wl.m} differs")
            library_ms = cuda_ms(lambda j: torch._int_mm(
                x2, ucopies[j % len(ucopies)]), 50)
            del wu, ucopies, lib
        rows.append({
            "stage": wl.stage, "grouped": True, "m": wl.m, "k": wl.k,
            "n": wl.n, "count": wl.count, "context": context, "bits": bits,
            "items": len(slices), "bytes": nbytes,
            "weight_copies": len(packed), "max_abs_err": err,
            "ms": cuda_ms(call, 200),
            "device_us": device_us(call, 50, "bitlinear_kernel"),
            "plain_ms": cuda_ms(lambda j: grouped_tile_gemm_ref(
                x, packed[j % len(packed)], plain, slices, bits=bits), 5),
            "library_ms": library_ms,
            "bound_ms": max(byte_ms, ops_ms),
            "bound_by": "bytes" if byte_ms >= ops_ms else "operations",
        })
        del x, packed, acc, plain
    return rows


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
    rows += grouped_rows()
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


# new tokens a request of phase serve: cut from 16 in PR 24 to keep the
# script near 900 s of phases, where the examples phase added ~150; the
# host-bound serving phases do not shorten with the model's depth (their
# Legion step programs run one layer and scale it), and 8 tokens still
# take 8 requests through 4 slots in two waves (PERF.md §4)
SERVE_NEW_TOKENS = 8


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
                       max_new_tokens=SERVE_NEW_TOKENS) for _ in range(8)]
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        if len(r.output) != SERVE_NEW_TOKENS or not all(
                0 <= t < cfg.vocab for t in r.output):
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
    """One decode step (m = 1, context 16) at both granularities: equal
    outputs and tallies; at kernel granularity one bitlinear launch per
    integer stage of the step (every stage of a BitNet step is integer and
    none is +ZTB)."""
    import numpy as np
    import torch

    from repro_torch.core import dlegion
    from repro_torch.kernels.bitlinear import ops
    from repro_torch.serve import LegionServeBackend

    per_step = {}
    tallies = {}
    outputs = {}
    seconds = {}
    for gran in ("kernel", "window"):
        backend = LegionServeBackend(dlegion(8), cfg, params,
                                     granularity=gran)
        ops.reset_launches()
        tallies[gran] = dataclasses.asdict(backend.step_tally(1, (16,)))
        per_step[gran] = sum(ops.LAUNCHES.values())
        prog = backend.step_program(1, (16,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs[gran] = backend.machine.run(prog, validate=False).outputs
        torch.cuda.synchronize()
        seconds[gran] = time.perf_counter() - t0
    same_tally = tallies["window"] == tallies["kernel"] == \
        dataclasses.asdict(kernel_backend.step_tally(1, (16,)))
    same_out = outputs["kernel"].keys() == outputs["window"].keys() and all(
        np.array_equal(outputs["kernel"][k], outputs["window"][k])
        for k in outputs["kernel"])
    if not (same_tally and same_out):
        raise AssertionError(f"window vs kernel granularity: tallies equal "
                             f"{same_tally}, outputs equal {same_out}")
    int_stages = len(prog)
    if per_step["kernel"] != int_stages:
        raise AssertionError(f"kernel granularity: {per_step['kernel']} "
                             f"bitlinear launches for {int_stages} integer "
                             "stages")
    emit({"phase": "window", "m": 1, "context": 16,
          "launches_per_decode_step": per_step, "integer_stages": int_stages,
          "step_run_seconds": seconds, "tallies_equal": True,
          "outputs_equal": True, "stages": len(outputs["kernel"])})


def _run_step(backend, m, contexts):
    """(outputs, seconds, bitlinear launches by bits) of one run of the
    step program of ``m`` rows and ``contexts`` on ``backend``'s Machine,
    and the program."""
    import torch

    from repro_torch.kernels.bitlinear import ops

    prog = backend.step_program(m, contexts)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = backend.machine.run(prog, validate=False).outputs
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(ops.LAUNCHES), prog


def phase_sharded(cfg, params):
    """BitNet-1.58B's step programs through LegionServeBackend(dlegion(8),
    window granularity, executor=ShardedExecutor()): a decode step (m = 1,
    context 16) and the prefill step of a 4-token prompt (m = 4, context
    4), outputs bit for bit and tallies exactly equal to the in-process
    window backend's, one device used, exactly one bitlinear launch at
    bits 8 per stage run per shard; then 2 prompts (4 and 6 tokens) x 8
    new tokens served by one ServeEngine priced by both backends at once,
    their tallies equal.  The host's walk of the window loop takes ~0.5 s
    a prompt token at window granularity (a 16-token prefill step took
    7.6 s in-process, 7.4 s sharded: PERF.md §6), so the prompts are
    short."""
    import numpy as np
    import torch

    from repro_torch.core import dlegion
    from repro_torch.kernels.bitlinear import ops
    from repro_torch.legion import ShardedExecutor
    from repro_torch.models import build_model
    from repro_torch.serve import LegionServeBackend, ServeEngine

    ex = ShardedExecutor()
    inproc = LegionServeBackend(dlegion(8), cfg, params, granularity="window")
    sharded = LegionServeBackend(dlegion(8), cfg, params, granularity="window",
                                 executor=ex)
    if sharded.machine.backend.name != "sharded":
        raise AssertionError(f"backend {sharded.machine.backend.name}")
    steps = {}
    sharded_launches = 0
    for label, m, contexts in (("decode", 1, (16,)), ("prefill", 4, (4,))):
        want, want_s, _, prog = _run_step(inproc, m, contexts)
        ex.devices_used = 0
        got, got_s, launches, _ = _run_step(sharded, m, contexts)
        shards = ex.devices_used
        same = want.keys() == got.keys() and all(
            np.array_equal(want[k], got[k]) for k in want)
        tally_in = dataclasses.asdict(inproc.step_tally(m, contexts))
        tally_sh = dataclasses.asdict(sharded.step_tally(m, contexts))
        if not same or tally_in != tally_sh:
            raise AssertionError(f"sharded {label}: outputs equal {same}, "
                                 f"tallies equal {tally_in == tally_sh}")
        if shards != 1 or launches != {2: 0, 4: 0, 8: len(prog) * shards}:
            raise AssertionError(f"sharded {label}: {shards} shards, "
                                 f"launches {launches} for {len(prog)} "
                                 "stages")
        sharded_launches += launches[8]
        steps[label] = {"m": m, "contexts": list(contexts),
                        "stages": len(prog), "devices_used": shards,
                        "launches_by_bits": launches,
                        "in_process_window_seconds": want_s,
                        "sharded_seconds": got_s}

    # serving: one engine, its steps priced by both backends
    api = build_model(cfg)
    eng = ServeEngine(api, params, max_slots=4, max_seq=256)
    by_inproc = LegionServeBackend(dlegion(8), cfg, params,
                                   granularity="window").attach(eng)
    by_sharded = LegionServeBackend(dlegion(8), cfg, params,
                                    granularity="window",
                                    executor=ex).attach(eng)
    # the sharded backend's own launches, apart from the in-process one's
    serve_launches = {b: 0 for b in ops.BITS}
    seconds = {"in_process": 0.0, "sharded": 0.0}
    observers = list(zip(("in_process", "sharded"), eng.step_observers[-2:]))

    def observed(name, fn):
        def call(event):
            before = dict(ops.LAUNCHES)
            t = time.perf_counter()
            fn(event)
            seconds[name] += time.perf_counter() - t
            if name == "sharded":
                for b in ops.BITS:
                    serve_launches[b] += ops.LAUNCHES[b] - before[b]
        return call
    eng.step_observers[-2:] = [observed(n, fn) for n, fn in observers]
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=n), max_new_tokens=8)
            for n in (4, 6)]
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(done) != 2 or not all(len(r.output) == 8 for r in reqs):
        raise AssertionError(f"sharded serve: {len(done)} of 2 finished")
    summary = by_sharded.summary()
    per_req = {u: dataclasses.asdict(t)
               for u, t in by_sharded.per_request.items()}
    if summary != by_inproc.summary() or per_req != {
            u: dataclasses.asdict(t)
            for u, t in by_inproc.per_request.items()}:
        raise AssertionError("sharded serve: tallies differ from the "
                             "in-process window backend's")
    if serve_launches[2] or serve_launches[4] or not serve_launches[8]:
        raise AssertionError(f"sharded serve launches {serve_launches}")
    sharded_launches += serve_launches[8]
    emit({"phase": "sharded", "model": cfg.name, "accelerator": "dlegion(8)",
          "granularity": "window", "devices_used": ex.devices_used,
          "steps": steps, "outputs_equal": True, "tallies_equal": True,
          "serve": {"requests": 2, "new_tokens": 8, "wall_seconds": wall,
                    "backend_seconds": seconds,
                    "prefill_steps": summary["prefill_steps"],
                    "decode_steps": summary["decode_steps"],
                    "cycles": summary["cycles"],
                    "bitlinear_launches_by_bits": serve_launches,
                    "tallies_equal": True},
          "bitlinear_launches": sharded_launches})
    return sharded_launches


def paged_run(cfg, params, trace_seed: int, device=None):
    """Reduced BitNet-1.58B through the serve_load engine settings on
    ``device``: the lognormal trace priced by its own backend; returns
    every engine and backend record the card-vs-CPU check compares."""
    from repro_torch.core import dlegion
    from repro_torch.models import build_model
    from repro_torch.obs import lognormal_trace, run_load
    from repro_torch.serve import (
        LegionServeBackend, LiveAdmission, PagedKVCache, ServeEngine,
    )

    api = build_model(cfg, device=device)
    chunk_logits = []             # every chunk's last logits, in call order

    def prefill_chunk(*args):
        logits, cache = api.prefill_chunk(*args)
        chunk_logits.append(logits[:, -1].float().cpu())
        return logits, cache
    paged = PagedKVCache(page_tokens=16, total_pages=16)
    backend = LegionServeBackend(
        dlegion(8), cfg.replace(quantization="bitnet"), params,
        granularity="kernel", page_tokens=16, device=device)
    eng = ServeEngine(dataclasses.replace(api, prefill_chunk=prefill_chunk),
                      params, max_slots=4, max_seq=256,
                      prefill_chunk_tokens=64, paged_kv=paged,
                      admission=LiveAdmission(backend,
                                              hbm_bytes_per_chip=2 ** 30))
    backend.attach(eng)
    chunks, tables = [], []

    def record(event):
        chunks.extend(c["last"] for c in event.get("chunks", ()))
        tables.append({u: paged.page_table(u)
                       for u in paged.eviction_order()})
    eng.step_observers.append(record)
    _serial, step_cycles = backend.step_pipeline(4, (64,) * 4)
    trace = lognormal_trace(
        8, mean_interarrival_cycles=1.25 * step_cycles, mean_prompt=48,
        mean_output=8, max_prompt=128, max_output=12, quantum=16,
        seed=trace_seed)
    summary = run_load(eng, backend, trace).summary()
    return {
        "summary": summary,
        "outputs": sorted((r.uid, r.output) for r in eng.finished),
        "step_log": eng.step_log, "preemptions": eng.preemptions,
        "tables": tables, "backend": backend.summary(),
        "per_request": {u: dataclasses.asdict(t)
                        for u, t in backend.per_request.items()},
        "last_logits": [lg for lg, last in zip(chunk_logits, chunks)
                        if last],
    }


def phase_serve_load(cfg, params):
    import numpy as np
    import torch

    from repro_torch.configs import reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.core import dlegion
    from repro_torch.kernels.bitlinear import ops
    from repro_torch.legion import Machine, PipelinedExecutor
    from repro_torch.models import build_model
    from repro_torch.obs import (
        SLO, RooflineTracer, TimelineTracer, lognormal_trace, run_load,
    )
    from repro_torch.serve import (
        LegionServeBackend, LiveAdmission, PagedKVCache, ServeEngine,
    )

    api = build_model(cfg)
    hbm = torch.cuda.get_device_properties(0).total_memory
    backend = LegionServeBackend(dlegion(8), cfg, params,
                                 granularity="kernel", page_tokens=16)
    paged = PagedKVCache(page_tokens=16, total_pages=16)
    eng = ServeEngine(api, params, max_slots=4, max_seq=256,
                      prefill_chunk_tokens=64, paged_kv=paged,
                      admission=LiveAdmission(backend,
                                              hbm_bytes_per_chip=hbm))
    backend.attach(eng)
    if not backend.check_outputs:
        raise AssertionError("serve_load must check every stage's output")
    # time the backend's share of each step, and keep the merged steps
    backend_s = [0.0]
    merged = []
    on_step = eng.step_observers.pop()

    def timed(event):
        t = time.perf_counter()
        on_step(event)
        backend_s[0] += time.perf_counter() - t
        if event["kind"] == "step" and event["chunks"] and event["uids"]:
            merged.append((
                tuple((c["tokens"], c["pos0"] + c["tokens"])
                      for c in event["chunks"]),
                tuple(sorted(p + 1 for p in event["positions"]))))
    eng.step_observers.append(timed)
    _serial, step_cycles = backend.step_pipeline(4, (64,) * 4)
    trace = lognormal_trace(
        8, mean_interarrival_cycles=1.25 * step_cycles, mean_prompt=48,
        mean_output=8, max_prompt=128, max_output=12, quantum=16, seed=2)
    slo = SLO(ttft_cycles=40.0 * step_cycles,
              per_token_cycles=4.0 * step_cycles)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    report = run_load(eng, backend, trace, slo=slo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    s = report.summary(freq_hz=backend.cfg.freq_hz)
    if (s["refused"] or s["requests"] != len(trace)
            or s["completed"] != len(trace)):
        raise AssertionError(f"serve_load: {s}")
    if s["preempted"] < 1 or eng.preemptions != s["preempted"]:
        raise AssertionError(f"no preemption under the tight pool: {s}")
    for r in eng.finished:
        if not r.done or len(r.output) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request {r.uid}: output {r.output}")
    if paged.stats().pinned_pages:
        raise AssertionError(f"pages left pinned: {paged.stats()}")
    if not (launches.get(2) and launches.get(8)):
        raise AssertionError(f"bitlinear launches by bits {launches}")
    tv, cv = backend.cross_validate(m=1, contexts=(256,))
    page_eq = all(v.measured.page_fetches == v.analytic.page_fetches
                  and v.measured.page_bytes == v.analytic.page_bytes
                  for v in tv)
    xval = max([e for v in tv for e in v.errors.values()]
               + [v.rel_err for v in cv])
    if not all(v.ok for v in tv + cv) or xval != 0 or not page_eq:
        raise AssertionError(f"cross_validate: worst error {xval}, page "
                             f"channel equal {page_eq}")
    bsum = backend.summary()

    # one merged step (chunks + decode): one launch per integer stage run
    if not merged:
        raise AssertionError("no step merged prefill chunks with decode")
    chunks, contexts = merged[0]
    prog = backend.step_program_mixed(chunks, contexts)
    ops.reset_launches()
    backend.machine.run(prog, validate=False)
    torch.cuda.synchronize()
    step_launches = sum(ops.LAUNCHES.values())
    if step_launches != len(prog):
        raise AssertionError(f"merged step {merged[0]}: {step_launches} "
                             f"bitlinear launches for {len(prog)} stages")
    accel = dlegion(8)
    timeline, roof = TimelineTracer(accel), RooflineTracer(accel)
    traced = Machine(accel, backend=PipelinedExecutor(),
                     granularity="kernel", instruments=[timeline, roof])
    rep = traced.run(prog, validate=False)
    page_cells = sum(c.page_fetches for c in timeline.programs[-1]
                     .cells.values())
    eff = max(p.efficiency for p in roof.rows())
    if (timeline.serial_cycles() != rep.serial_cycles
            or timeline.overlapped_cycles() != rep.total_cycles
            or rep.pipeline is None
            or rep.pipeline.overlapped_cycles != rep.total_cycles
            or not page_cells or eff > 1):
        raise AssertionError(
            f"tracers: serial {timeline.serial_cycles()} vs "
            f"{rep.serial_cycles}, overlapped {timeline.overlapped_cycles()}"
            f" vs {rep.total_cycles}, page cells {page_cells}, "
            f"max efficiency {eff}")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    timeline.export(os.path.join(ROOT, "build",
                                 "serve_load_merged_step.json"))

    # full width: a 128-token prompt as 64 + 64 against the whole prefill
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, size=(1, 128))).to(api.device)
    whole, _ = api.prefill(params, {"tokens": prompt},
                           api.init_cache(1, 256))
    cache = api.init_cache(1, 256)
    _lg, cache = api.prefill_chunk(params, prompt[:, :64], cache, 0)
    part, cache = api.prefill_chunk(params, prompt[:, 64:], cache, 64)
    chunk_diff = float((part.float() - whole.float()).abs().max())
    top1 = int(part.argmax()) == int(whole.argmax())
    if not bool(torch.isfinite(part).all()) or chunk_diff > CHUNK_BF16_ATOL:
        raise AssertionError(f"bf16 chunked vs whole prefill: max abs diff "
                             f"{chunk_diff} > {CHUNK_BF16_ATOL}")
    del whole, part, cache

    # reduced BitNet-1.58B (float32, no quantization, whose int8 rounding
    # would turn float32 ulps into whole steps) on the card and the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    small = reduced(cfg).replace(dtype="float32", quantization="none")
    p_cpu = build_model(small, device="cpu").init(0)
    runs = {"cpu": paged_run(small, p_cpu, 2, device="cpu"),
            "card": paged_run(small, params_from_jax(_numpy_tree(p_cpu)),
                              2)}
    card, cpu = runs["card"], runs["cpu"]
    same = {k: card[k] == cpu[k] for k in (
        "outputs", "step_log", "preemptions", "tables", "backend",
        "per_request", "summary")}
    logit_diff = max(float((a - b).abs().max()) for a, b in zip(
        card["last_logits"], cpu["last_logits"]))
    if (not all(same.values()) or card["preemptions"] < 1
            or len(card["last_logits"]) != len(cpu["last_logits"])
            or logit_diff > 1e-4):
        raise AssertionError(f"card vs CPU paged in-flight engine: equal "
                             f"{same}, preemptions {card['preemptions']}, "
                             f"last-chunk logits {logit_diff}")

    tokens = sum(len(r.output) for r in eng.finished)
    emit({"phase": "serve_load", "model": cfg.name, "layers": cfg.layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "requests": s["requests"], "completed": s["completed"],
          "refused": s["refused"], "deferred": s["deferred"],
          "preempted": s["preempted"], "goodput": s["goodput"],
          "engine_steps": bsum["engine_steps"],
          "merged_steps": len(merged),
          "p50_ttft_cycles": s["p50_ttft_cycles"],
          "p99_ttft_cycles": s["p99_ttft_cycles"],
          "p50_tok_cycles": s["p50_tok_cycles"],
          "p99_tok_cycles": s["p99_tok_cycles"],
          "mean_occupancy": s["mean_occupancy"],
          "page_fetch_bytes": bsum["page_fetch_bytes"],
          "page_waste_frac": bsum["page_waste_frac"],
          "page_xval_err": xval, "wall_seconds": wall,
          "legion_backend_seconds": backend_s[0],
          "tokens": tokens, "tokens_per_s": tokens / wall,
          "bitlinear_launches_by_bits": launches,
          "merged_step": {"chunks": chunks, "decode_contexts": contexts,
                          "stages": len(prog),
                          "bitlinear_launches": step_launches,
                          "serial_cycles": rep.serial_cycles,
                          "overlapped_cycles": rep.total_cycles,
                          "page_fetches": page_cells,
                          "max_roofline_efficiency": eff},
          "chunk_bf16_max_abs_diff": chunk_diff, "chunk_bf16_top1": top1,
          "chunk_bf16_tolerance": CHUNK_BF16_ATOL,
          "reduced_card_vs_cpu_equal": same,
          "reduced_last_chunk_logit_diff": logit_diff,
          "peak_memory_bytes": peak})
    return launches


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
                    row["device_us"] = device_us(call, 50,
                                                "block_sparse_i8_mma_kernel")
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


# the SSD scan's kernels, matched by exact name in the profiler's trace:
# three a forward call, and a backward call's four (three where the heads
# do not share B and C, whose sum over the heads then needs no kernel)
SSD_KERNELS = ("ssd_kernel_state", "ssd_kernel_pass", "ssd_kernel_scan")
SSD_BWD_KERNELS = ("ssd_bwd_kernel_state", "ssd_bwd_kernel_pass",
                   "ssd_bwd_kernel_scan", "ssd_bwd_kernel_headsum")


def ssd_operands(nb, nh, s, n, p, seed):
    """dta [B, H, S], dtx [B, H, S, P] and head-shared B, C, float32 on the
    card in the layout the Mamba-2 block hands over: dta and dtx as
    transposed views of [B, S, H] and [B, S, H, P], B and C as [B, S, N]
    expanded over heads (stride 0); scaled as the model scales them
    (dt ~ softplus, A = -exp(a_log))."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.2, size=(nb, s, nh)).astype(np.float32)
    a = -np.exp(rng.standard_normal((1, 1, nh))).astype(np.float32)
    x = rng.standard_normal((nb, s, nh, p)).astype(np.float32)
    bm = rng.standard_normal((nb, 1, s, n)).astype(np.float32)
    cm = rng.standard_normal((nb, 1, s, n)).astype(np.float32)
    dev = lambda t: torch.from_numpy(t).cuda()             # noqa: E731
    return (dev(dt * a).transpose(1, 2),
            dev(x * dt[..., None]).transpose(1, 2),
            dev(bm).expand(nb, nh, s, n), dev(cm).expand(nb, nh, s, n))


def ssd_bound(nb, nh, s, n, p, chunk, shared_bc):
    """(bound ms, "bytes" | "operations") of the SSD scan: the package's
    formula (``repro_torch.kernels.cost.ssd_bound``), which the dry run's
    cost counter reads too."""
    from repro_torch.kernels.cost import ssd_bound as bound

    return bound(nb, nh, s, n, p, chunk, shared_bc)


def phase_ssd():
    import torch

    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = (("zamba2-7b prefill", 1, 112, 4096, 64, 64, 128),
              ("zamba2-7b short prompt", 1, 112, 23, 64, 64, 23),
              ("mamba2-130m prefill", 1, 24, 1024, 128, 64, 128))
    rows = []
    for label, nb, nh, s, n, p, chunk in shapes:
        dta, dtx, bm, cm = ssd_operands(nb, nh, s, n, p, s + n)
        flat = lambda t: t.reshape(nb * nh, *t.shape[2:])  # noqa: E731
        plain = lambda: ssd_chunked_ref(                   # noqa: E731
            flat(dta), flat(dtx), flat(bm), flat(cm), chunk=chunk,
            return_state=True)
        call = lambda i: ssd_ops.ssd(                      # noqa: E731
            dta, dtx, bm, cm, chunk=chunk, return_state=True)
        y, h = call(0)
        y_ref, h_ref = plain()
        torch.cuda.synchronize()
        y, h = flat(y), flat(h)
        err = max(float((y - y_ref).abs().max()),
                  float((h - h_ref).abs().max()))
        if not (torch.allclose(y, y_ref, rtol=1e-4, atol=1e-4)
                and torch.allclose(h, h_ref, rtol=1e-4, atol=1e-4)):
            raise AssertionError(f"ssd {label}: max_abs_err {err}")
        iters = 20 if s > 1024 else 100
        bound, by = ssd_bound(nb, nh, s, n, p, chunk,
                              bm.stride(1) == 0 and cm.stride(1) == 0)
        rows.append({
            "shape": label, "bh": nb * nh, "s": s, "n": n, "p": p,
            "chunk": chunk, "max_abs_err": err,
            "y_max_abs": float(y_ref.abs().max()),
            "ms": cuda_ms(call, iters),
            "device_us": device_us(call, 5, SSD_KERNELS,
                                   per_call=len(SSD_KERNELS)),
            "plain_ms": cuda_ms(lambda i: plain(), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
        })
    for r in rows:
        emit(dict(phase="ssd", **r))
    return rows


# the SSD backward against its plain version: rtol 1e-4, atol 1e-5 x the
# largest |gradient| of each output (float32 summed in another order; a
# dta gradient sums a chunk's terms and runs to a few hundred)
SSD_BWD_RTOL, SSD_BWD_ATOL_MAX = 1e-4, 1e-5
SSD_BWD_SHAPES = (
    # label, B, H, S, N, P, chunk, with the terminal state's gradient
    ("zamba2-7b train", 1, 112, 4096, 64, 64, 128, False),
    ("mamba2-130m train", 1, 24, 4096, 128, 64, 128, False),
    # a short prompt: 7 whole chunks and one of 104 steps
    ("zamba2-7b short prompt", 1, 112, 1000, 64, 64, 128, True),
)


def phase_ssd_bwd():
    """The SSD backward kernels (csrc/ssd_bwd.cu) against the plain
    backward (ssd_chunked_bwd_ref) on the card, from the forward kernel's
    own scratch, B and C shared by the heads as the model passes them
    ([B, S, N]): every gradient within SSD_BWD_RTOL / SSD_BWD_ATOL_MAX x
    max|g|, two calls equal bit for bit; then the same through ssd() under
    autograd, which must launch the backward once and give the same bits.
    Times the backward call, its device time (summed, and by kernel), the
    plain backward, the bounds (the tensor cores' 3xTF32 rate, the
    kernel's path, and the float32 CUDA cores')."""
    import numpy as np
    import torch

    from repro_torch.kernels.cost import F32_OPS_PER_S, ssd_bwd_bound
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    rows = []
    for label, nb, nh, s, n, p, chunk, with_dh in SSD_BWD_SHAPES:
        dta, dtx, b4, c4 = ssd_operands(nb, nh, s, n, p, s + n + 1)
        bm, cm = b4[:, 0], c4[:, 0]                      # [B, S, N]
        rng = np.random.default_rng(s + p)
        # dy as autograd hands it over for the model's y: [B, S, H, P]
        # memory seen as [B, H, S, P]
        dy = torch.from_numpy(rng.standard_normal((nb, s, nh, p)).astype(
            np.float32)).cuda().transpose(1, 2)
        dh = (torch.from_numpy(rng.standard_normal((nb, nh, n, p)).astype(
            np.float32)).cuda() if with_dh else None)
        scratch = ssd_ops._scratch(dtx, n, chunk)
        _, h = ssd_ops._launch(dta, dtx, b4, c4, chunk, with_dh, scratch)
        call = lambda i: ssd_ops._launch_bwd(              # noqa: E731
            dta, dtx, bm, cm, dy, scratch, h, dh, chunk)
        before = ssd_ops.LAUNCHES["backward_float32"]
        got, again = call(0), call(1)
        flat = lambda t: t.reshape(nb * nh, *t.shape[2:])  # noqa: E731

        def plain():
            g = ssd_chunked_bwd_ref(
                flat(dta), flat(dtx), flat(b4), flat(c4), flat(dy),
                chunk=chunk, dh_final=flat(dh) if with_dh else None)
            return (g[0].reshape(nb, nh, s), g[1].reshape(nb, nh, s, p),
                    g[2].reshape(nb, nh, s, n).sum(1),
                    g[3].reshape(nb, nh, s, n).sum(1))

        want = plain()
        torch.cuda.synchronize()
        if ssd_ops.LAUNCHES["backward_float32"] != before + 2:
            raise AssertionError(f"ssd_bwd {label}: launches "
                                 f"{ssd_ops.LAUNCHES}")
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = {}
        for name, g, w in zip(("ddta", "ddtx", "db", "dc"), got, want):
            errs[name] = float((g - w).abs().max())
            scale = float(w.abs().max())
            if not torch.allclose(g, w, rtol=SSD_BWD_RTOL,
                                  atol=SSD_BWD_ATOL_MAX * scale):
                raise AssertionError(f"ssd_bwd {label} {name}: max abs err "
                                     f"{errs[name]} (max |want| {scale})")
        if not bit_equal:
            raise AssertionError(f"ssd_bwd {label}: two calls differ")
        del want, again
        iters = 10 if s > 1024 else 30
        bound, by = ssd_bwd_bound(nb, nh, s, n, p, chunk, True, with_dh)
        bound_f32, by_f32 = ssd_bwd_bound(nb, nh, s, n, p, chunk, True,
                                          with_dh, op_rate=F32_OPS_PER_S)
        by_kernel = device_us_by_kernel(call, 3, SSD_BWD_KERNELS,
                                        per_call=len(SSD_BWD_KERNELS))
        rows.append({
            "shape": label, "b": nb, "h": nh, "s": s, "n": n, "p": p,
            "chunk": chunk, "shared_bc": True, "dh_final": with_dh,
            "head_group": ssd_ops.head_group(nb, nh, -(-s // chunk)),
            "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
            "grad_max_abs": {k: float(g.abs().max()) for k, g in zip(
                ("ddta", "ddtx", "db", "dc"), got)},
            "tolerance": {"rtol": SSD_BWD_RTOL,
                          "atol": f"{SSD_BWD_ATOL_MAX} * max|g|"},
            "bit_equal": bit_equal,
            "ms": cuda_ms(call, iters),
            "device_us": (sum(by_kernel.values()) if by_kernel is not None
                          else None),
            "device_us_by_kernel": by_kernel,
            "plain_ms": cuda_ms(lambda i: plain(), 2),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bound_f32_ms": bound_f32, "bound_f32_by": by_f32,
        })
        if with_dh:
            # through ssd() under autograd: the Function's backward is the
            # backward kernel, once, on the same values
            leaves = [t.detach().clone().requires_grad_()
                      for t in (dta, dtx, bm, cm)]
            before = dict(ssd_ops.LAUNCHES)
            y, hfin = ssd_ops.ssd(*leaves, chunk=chunk, return_state=True)
            grads = torch.autograd.grad((y, hfin), leaves, (dy, dh))
            torch.cuda.synchronize()
            launched = {k: ssd_ops.LAUNCHES[k] - before[k] for k in before}
            if launched != {"float32": 1, "backward_float32": 1}:
                raise AssertionError(f"ssd_bwd autograd launches {launched}")
            if not all(torch.equal(a, b) for a, b in zip(grads, got)):
                raise AssertionError("ssd_bwd: ssd() under autograd differs "
                                     "from the direct backward call")
            rows[-1]["autograd_bit_equal"] = True
    for r in rows:
        emit(dict(phase="ssd_bwd", **r))
    return rows


def flash_bound(b, h, hkv, sq, sk, d, causal, elt, q_offset=0):
    """(bound ms, "bytes" | "operations") of a flash forward call:
    ``repro_torch.kernels.cost.flash_bound`` (q, the keys and values the
    call reaches, and o over HBM against the two products over the
    unmasked pairs at the type's peak)."""
    from repro_torch.kernels.cost import flash_bound as bound

    return bound(b, h, hkv, sq, sk, d, causal, elt, q_offset)


def phase_flash():
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 is held against the plain version in float32 on the same values:
    # the kernel's math is float32, so the two differ by the output's one
    # bf16 rounding (at most 2^-8 relative) and float32 summation order
    bf16, f32 = dict(rtol=8e-3, atol=2e-5), dict(rtol=2e-4, atol=2e-5)
    shapes = (("zamba2-7b prefill", 32, 32, 4096, 112, True, torch.bfloat16,
               bf16),
              ("zamba2-7b prefill f32", 32, 32, 1024, 112, True,
               torch.float32, f32),
              ("gqa", 32, 8, 1024, 128, True, torch.float32, f32),
              # the long prefills of the moe, encoder and vlm families
              ("granite-moe-3b-a800m prefill", 24, 8, 4096, 64, True,
               torch.bfloat16, bf16),
              ("hubert-xlarge", 16, 16, 4096, 80, False, torch.bfloat16,
               bf16),
              ("internvl2-76b prefill", 64, 8, 4096, 128, True,
               torch.bfloat16, bf16))
    rows = []
    lse_before = fa.LAUNCHES["lse_float32"] + fa.LAUNCHES["lse_bfloat16"]
    for label, h, hkv, s, d, causal, dtype, tol in shapes:
        rng = np.random.default_rng(s + h + hkv + d)
        # [B, S, H, d] tensors handed over as [B, H, S, d] views, as the
        # attention layer does
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, s, heads, d)).astype(np.float32)).to(
                device="cuda", dtype=dtype).transpose(1, 2)
            for heads in (h, hkv, hkv))
        call = lambda i: fa.flash_attention(q, k, v,          # noqa: E731
                                            causal=causal)
        plain = lambda cast: attention_ref(                   # noqa: E731
            cast(q).reshape(h, s, d), cast(k).reshape(hkv, s, d),
            cast(v).reshape(hkv, s, d), q_heads=h, kv_heads=hkv,
            causal=causal).reshape(1, h, s, d)
        got = call(0).float()
        want = plain(lambda t: t.float())
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        median_want = float(want.abs().median())
        if not torch.allclose(got, want, **tol):
            raise AssertionError(f"flash {label}: max_abs_err {err} "
                                 f"(median |want| {median_want})")
        del got, want
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        kw = {"enable_gqa": True} if hkv != h else {}
        iters = 10 if s > 1024 else 30
        bound, by = flash_bound(1, h, hkv, s, s, d, causal,
                                2 if dtype == torch.bfloat16 else 4)
        rows.append({
            "shape": label, "b": 1, "h": h, "hkv": hkv, "s": s, "d": d,
            "dtype": str(dtype)[6:], "causal": causal, "max_abs_err": err,
            "median_abs_want": median_want, "tolerance": tol,
            "ms": cuda_ms(call, iters),
            # by type, so that a late event of the other kernel never counts
            "device_us": device_us(call, 3, "flash_kernel_bf16_wgmma" if dtype
                                   == torch.bfloat16 else "flash_kernel_f32"),
            "plain_ms": cuda_ms(lambda i: plain(lambda t: t), 3),
            "library_ms": cuda_ms(lambda i: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=causal, **kw), iters),
            "bound_ms": bound, "bound_by": by,
        })
    # every row ran the serve launch: a null lse pointer, nothing written
    lse = fa.LAUNCHES["lse_float32"] + fa.LAUNCHES["lse_bfloat16"]
    if lse != lse_before:
        raise AssertionError(f"flash serve rows wrote an lse {lse - lse_before}"
                             " times")
    for r in rows:
        emit(dict(phase="flash", lse_launches=lse - lse_before, **r))
    return rows


def phase_hybrid_model():
    """The Mamba-2 and hybrid model math on the card against the CPU:
    reduced configs in float32 without quantization, a 3072-token prefill
    (the hybrid's attention takes the flash path) and 3 decode steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("zamba2-7b", "mamba2-130m"):
        cfg = reduced(get_config(arch)).replace(
            dtype="float32", quantization="none")
        cpu = build_model(cfg, device="cpu")
        gpu = build_model(cfg)
        p_cpu = cpu.init(0)
        p_gpu = params_from_jax(_numpy_tree(p_cpu))
        s = 3072
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            1, cfg.vocab, size=(2, s)))
        ssd_ops.reset_launches()
        fa.reset_launches()
        lc, cc = cpu.prefill(p_cpu, {"tokens": toks}, cpu.init_cache(2, s + 8))
        lg, cg = gpu.prefill(p_gpu, {"tokens": toks.cuda()},
                             gpu.init_cache(2, s + 8))
        torch.cuda.synchronize()
        launches = {"ssd": sum(ssd_ops.LAUNCHES.values()),
                    "flash": sum(fa.LAUNCHES.values())}
        worst = state_err = 0.0
        pos = torch.tensor([s, s])
        for _ in range(3):
            if not torch.isfinite(lg).all() or tuple(lg.shape) != (
                    2, 1, cfg.vocab):
                raise AssertionError(f"{arch}: bad logits "
                                     f"{tuple(lg.shape)}")
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            state_err = max(state_err,
                            float((cg.state.cpu() - cc.state).abs().max()))
            tok = torch.argmax(lc[:, -1], dim=-1)
            lc, cc = cpu.decode(p_cpu, tok, cc, pos)
            lg, cg = gpu.decode(p_gpu, tok.cuda(), cg, pos.cuda())
            pos = pos + 1
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        apps = -(-cfg.layers // cfg.attn_every) if cfg.attn_every else 0
        if launches != {"ssd": cfg.layers, "flash": apps}:
            raise AssertionError(f"{arch} prefill launches {launches}")
        # float32 on both, summed in other orders: 1e-4 absolute on logits
        if worst > 1e-4:
            raise AssertionError(f"{arch} card vs CPU: max abs diff {worst}")
        emit({"phase": "hybrid_model", "config": cfg.name,
              "dtype": "float32", "prompt_tokens": s, "batch": 2,
              "prefill_launches": launches, "max_abs_diff_vs_cpu": worst,
              "state_max_abs_diff": state_err, "tolerance": 1e-4})


def timed_api(api):
    """``api`` with its prefill, decode and chunked prefill timed apart
    (host clock; the logits' finiteness check synchronises) and every
    call's logits checked finite; returns (api, seconds by kind, calls by
    kind)."""
    import torch

    clock = {"prefill": 0.0, "decode": 0.0, "prefill_chunk": 0.0}
    calls = dict.fromkeys(clock, 0)

    def timed(kind, fn):
        def run(*args):
            t = time.perf_counter()
            logits, cache = fn(*args)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite {kind} logits")
            clock[kind] += time.perf_counter() - t
            calls[kind] += 1
            return logits, cache
        return run if fn is not None else None
    return dataclasses.replace(
        api, prefill=timed("prefill", api.prefill),
        decode=timed("decode", api.decode),
        prefill_chunk=timed("prefill_chunk", api.prefill_chunk)), clock, calls


def traced_prefill(api, params, prompt, max_seq):
    """One single-request prefill as ServeEngine runs it, under
    torch.profiler: its wall seconds (profiler on) and the device time
    summed from the trace, for every kernel and for the SSD and flash
    kernels alone; None where the trace shows no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(prompt[None, :].astype("int64")).to(api.device)
    cache = api.init_cache(1, max_seq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = api.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits in the traced prefill")
    ms = {"all": 0.0, "ssd_kernel": 0.0, "flash_kernel": 0.0}
    calls = dict.fromkeys(ms, 0)
    for evt in prof.events():
        if not on_card(evt):
            continue
        for name in ms:
            if name == "all" or name in evt.name:
                ms[name] += evt.time_range.elapsed_us() / 1e3
                calls[name] += 1
    if not calls["all"]:
        return {"prompt_tokens": len(prompt), "wall_seconds": wall,
                "device_ms": None}
    return {"prompt_tokens": len(prompt), "wall_seconds": wall,
            "device_ms": ms, "device_calls": calls,
            "device_idle_share": 1 - ms["all"] / (wall * 1e3)}


def phase_hybrid_serve():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import n_attn_apps
    from repro_torch.serve import ServeEngine

    cfg = get_config("zamba2-7b")
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, setup_s, n_params = full_params(api)
    plain_api = api
    api, clock, _ = timed_api(api)
    eng = ServeEngine(api, params, max_slots=4, max_seq=4352)
    rng = np.random.default_rng(0)
    lengths = (4096, int(rng.integers(4, 24)), 4096, int(rng.integers(4, 24)))
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=n), max_new_tokens=16)
            for n in lengths]
    ssd_ops.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ssd": sum(ssd_ops.LAUNCHES.values()),
                "flash": sum(fa.LAUNCHES.values())}
    _check_done(reqs, done, 16, cfg.vocab)
    long_prompts = sum(n > 2048 for n in lengths)
    want = {"ssd": cfg.layers * len(reqs),
            "flash": n_attn_apps(cfg) * long_prompts}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    max_seq, decode_steps = eng.max_seq, len(eng.decode_batch_sizes)
    del eng
    traced = traced_prefill(plain_api, params, reqs[0].prompt, max_seq)
    tokens = sum(len(r.output) for r in done)
    emit({"phase": "hybrid_serve", "model": cfg.name, "layers": cfg.layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": n_params,
          "setup_seconds": setup_s, "requests": len(done),
          "prompt_tokens": list(lengths), "tokens": tokens,
          "wall_seconds": wall, "tokens_per_s": tokens / wall,
          "prefill_seconds": clock["prefill"],
          "decode_seconds": clock["decode"],
          "decode_steps": decode_steps,
          "launches": launches,
          "peak_memory_bytes": peak, "traced_prefill": traced})
    return launches


def full_params(api):
    """Random parameters of ``api``'s config (bf16) from a seeded
    torch.Generator on the card, ternary-prepared for serving: (params,
    seconds that took, parameter count)."""
    import torch

    from repro_torch.serve.engine import prepare_params

    t0 = time.perf_counter()
    gen = torch.Generator(device=api.device)
    gen.manual_seed(0)
    params = prepare_params(api.init(gen))
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            sum(t.numel() for t in _leaves(params)))


def _check_done(reqs, done, new_tokens, vocab):
    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        if len(r.output) != new_tokens or not all(0 <= t < vocab
                                                  for t in r.output):
            raise AssertionError(f"request {r.uid}: output {r.output}")


def phase_moe_serve():
    """Full granite-moe-3b-a800m through ServeEngine: legacy mode with two
    4096-token prompts (every layer's attention on the flash kernel), then
    the same params in-flight (64-token chunks)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("granite-moe-3b-a800m")
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, setup_s, n_params = full_params(api)
    tapi, clock, _ = timed_api(api)
    eng = ServeEngine(tapi, params, max_slots=4, max_seq=4352)
    rng = np.random.default_rng(0)
    lengths = (4096, 23, 4096, 16)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=n), max_new_tokens=16)
            for n in lengths]
    fa.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sum(fa.LAUNCHES.values())
    _check_done(reqs, done, 16, cfg.vocab)
    want = cfg.layers * sum(n > 2048 for n in lengths)
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    tokens = sum(len(r.output) for r in done)
    legacy = {"prompt_tokens": list(lengths), "tokens": tokens,
              "wall_seconds": wall, "tokens_per_s": tokens / wall,
              "prefill_seconds": clock["prefill"],
              "decode_seconds": clock["decode"],
              "decode_steps": len(eng.decode_batch_sizes),
              "flash_launches": launches}
    del eng
    legacy["traced_prefill"] = traced_prefill(api, params, reqs[0].prompt,
                                              4352)

    tapi, clock, calls = timed_api(api)
    eng = ServeEngine(tapi, params, max_slots=4, max_seq=256,
                      prefill_chunk_tokens=64)
    lengths = [int(n) for n in rng.integers(40, 201, size=4)]
    reqs = [eng.submit(rng.integers(1, cfg.vocab, size=n), max_new_tokens=8)
            for n in lengths]
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_done(reqs, done, 8, cfg.vocab)
    if calls["prefill_chunk"] == 0:
        raise AssertionError("the in-flight run called no prefill_chunk")
    tokens = sum(len(r.output) for r in done)
    emit({"phase": "moe_serve", "model": cfg.name, "layers": cfg.layers,
          "d_model": cfg.d_model,
          "experts": [cfg.n_experts, cfg.n_experts_total],
          "top_k": cfg.top_k, "dtype": cfg.dtype, "params": n_params,
          "setup_seconds": setup_s, "legacy": legacy,
          "inflight": {"prompt_tokens": lengths, "chunk_tokens": 64,
                       "tokens": tokens, "wall_seconds": wall,
                       "tokens_per_s": tokens / wall,
                       "prefill_chunk_calls": calls["prefill_chunk"],
                       "prefill_chunk_seconds": clock["prefill_chunk"],
                       "decode_seconds": clock["decode"],
                       "steps": len(eng.step_log)},
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return launches


def phase_encoder():
    """Full hubert-xlarge on one batch of 4096 frames (82 s of 16 kHz audio
    at 20 ms a frame), given in the config's type as make_batch_spec gives
    them: train_logits and prefill, every layer's non-causal attention on
    the flash kernel; the model is bidirectional and cannot be served."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models.common import dtype_of
    from repro_torch.serve import ServeEngine

    cfg = get_config("hubert-xlarge")
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, setup_s, n_params = full_params(api)
    s = 4096
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)).to(api.device,
                                                    dtype_of(cfg))
    seconds, launches = {}, {}

    def run(name, fn):
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = sum(fa.LAUNCHES.values())
        if launches[name] != cfg.layers:
            raise AssertionError(f"{name}: {launches[name]} flash launches, "
                                 f"expected {cfg.layers}")
        return out

    logits = run("train_logits",
                 lambda: api.train_logits(params, {"frames": frames}))
    last, _ = run("prefill", lambda: api.prefill(
        params, {"frames": frames}, api.init_cache(1, s)))
    if (tuple(logits.shape) != (1, s, cfg.vocab)
            or tuple(last.shape) != (1, 1, cfg.vocab)
            or not bool(torch.isfinite(logits).all())
            or not bool(torch.isfinite(last).all())):
        raise AssertionError(f"logits {tuple(logits.shape)}, "
                             f"{tuple(last.shape)}")
    moved = frames.clone()
    moved[:, -1] = 5.0
    moved_logits = run("train_logits_moved",
                       lambda: api.train_logits(params, {"frames": moved}))
    frame0_shift = float((moved_logits[:, 0] - logits[:, 0]).abs().max())
    if frame0_shift == 0:
        raise AssertionError("the last frame does not reach frame 0's logits")
    try:
        ServeEngine(api, params)
    except ValueError as err:
        if "encoder-only; no decode" not in str(err):
            raise
    else:
        raise AssertionError("ServeEngine took an encoder-only model")
    emit({"phase": "encoder", "model": cfg.name, "layers": cfg.layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "head_dim": cfg.head_dim_, "dtype": cfg.dtype, "params": n_params,
          "setup_seconds": setup_s, "frames": s, "seconds": seconds,
          "flash_launches": launches,
          "last_vs_prefill_max_abs_diff": float(
              (logits[:, -1:] - last).abs().max()),
          "frame0_shift": frame0_shift,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return launches["prefill"]


def phase_vlm():
    """internvl2-76b at full width, 8 of its 80 layers: a prefill of 256
    patch embeddings and 3840 text tokens (every layer's attention on the
    flash kernel), 8 decode steps, and the loss over the text."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models.common import cross_entropy, dtype_of

    full = get_config("internvl2-76b")
    cfg = full.replace(layers=8)
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, setup_s, n_params = full_params(api)
    s, text = 4096, 4096 - cfg.num_patches
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.from_numpy(rng.integers(
            1, cfg.vocab, size=(1, text))).to(api.device),
        "patch_embeds": torch.from_numpy(rng.standard_normal(
            (1, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(
                api.device, dtype_of(cfg)),
        "targets": torch.from_numpy(rng.integers(
            1, cfg.vocab, size=(1, text))).to(api.device),
    }
    cache = api.init_cache(1, s + 8)
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = sum(fa.LAUNCHES.values())
    if launches != cfg.layers:
        raise AssertionError(f"prefill: {launches} flash launches, expected "
                             f"{cfg.layers}")
    t0 = time.perf_counter()
    for step in range(8):
        if not bool(torch.isfinite(logits).all()) or tuple(
                logits.shape) != (1, 1, cfg.vocab):
            raise AssertionError(f"step {step}: logits "
                                 f"{tuple(logits.shape)}")
        tok = torch.argmax(logits[:, -1], dim=-1)
        logits, cache = api.decode(params, tok, cache, s + step)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite decode logits")
    full_logits = api.train_logits(params, batch)
    loss = float(api.loss(params, batch))
    over_text = float(cross_entropy(full_logits[:, cfg.num_patches:],
                                    batch["targets"]))
    if (tuple(full_logits.shape) != (1, s, cfg.vocab)
            or not np.isfinite(loss) or abs(loss - over_text) > 1e-3):
        raise AssertionError(f"logits {tuple(full_logits.shape)}, loss "
                             f"{loss}, over the text {over_text}")
    emit({"phase": "vlm", "model": cfg.name, "layers": cfg.layers,
          "reduced": {"layers": [full.layers, cfg.layers]},
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.kv_heads],
          "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff, "dtype": cfg.dtype,
          "params": n_params, "setup_seconds": setup_s,
          "patches": cfg.num_patches, "text_tokens": text,
          "prefill_seconds": prefill_s, "decode_steps": 8,
          "decode_seconds": decode_s, "flash_launches": launches,
          "loss": loss, "loss_over_text": over_text,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return launches


def routing_flips(idx_a, idx_b, probs, k, tol=1e-5):
    """Tokens whose routed experts differ between two runs, and the
    smallest margin between the k-th and (k+1)-th router probabilities
    (``probs`` from the CPU) over all tokens.  A flip is allowed only at
    such a near-tie: it raises unless that token's margin is within
    ``tol``."""
    import torch

    top = torch.sort(probs, dim=-1, descending=True).values
    margin = top[..., k - 1] - top[..., k]
    flipped = (idx_a != idx_b).any(dim=-1)
    if bool((margin[flipped] > tol).any()):
        raise AssertionError(f"routing flipped at margins "
                             f"{margin[flipped].tolist()}")
    return int(flipped.sum()), float(margin.min())


def phase_families_model():
    """The moe, encoder and vlm model math on the card against the CPU:
    reduced configs in float32 without quantization.  MoE: a 64-token
    prefill and 3 decode steps, the routed experts of every layer compared
    (a flip only at a near-tie); encoder: 3072 frames (the float32 flash
    kernel, non-causal); VLM: 256 patches + 2816 tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def pair(cfg):
        cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
        p_cpu = cpu.init(0)
        return cpu, p_cpu, gpu, params_from_jax(_numpy_tree(p_cpu))

    # MoE, with dummy experts present
    cfg = reduced(get_config("granite-moe-3b-a800m")).replace(
        n_experts_padded=12, dtype="float32", quantization="none")
    cpu, p_cpu, gpu, p_gpu = pair(cfg)
    routes = {"cpu": [], "cuda": []}
    route = moe.route

    def recorded(p, cfg_, x):
        probs, gates, idx = route(p, cfg_, x)
        routes[x.device.type].append((probs.cpu(), idx.cpu()))
        return probs, gates, idx
    moe.route = recorded
    try:
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            1, cfg.vocab, size=(2, 64)))
        lc, cc = cpu.prefill(p_cpu, {"tokens": toks}, cpu.init_cache(2, 72))
        lg, cg = gpu.prefill(p_gpu, {"tokens": toks.cuda()},
                             gpu.init_cache(2, 72))
        worst, pos = 0.0, torch.tensor([64, 64])
        for _ in range(3):
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            tok = torch.argmax(lc[:, -1], dim=-1)
            lc, cc = cpu.decode(p_cpu, tok, cc, pos)
            lg, cg = gpu.decode(p_gpu, tok.cuda(), cg, pos.cuda())
            pos = pos + 1
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
    finally:
        moe.route = route
    if len(routes["cpu"]) != 4 * cfg.layers or len(routes["cuda"]) != len(
            routes["cpu"]):
        raise AssertionError(f"routed {len(routes['cpu'])} / "
                             f"{len(routes['cuda'])} MoE calls")
    flips, margin = 0, float("inf")
    for (probs, idx_c), (_, idx_g) in zip(routes["cpu"], routes["cuda"]):
        n, m = routing_flips(idx_g, idx_c, probs, cfg.top_k)
        flips, margin = flips + n, min(margin, m)
    # float32 on both, summed in other orders: 1e-4 absolute on logits,
    # held where every routed expert agrees
    if flips == 0 and worst > 1e-4:
        raise AssertionError(f"moe card vs CPU: max abs diff {worst}")
    emit({"phase": "families_model", "config": cfg.name, "dtype": "float32",
          "experts": [cfg.n_experts, cfg.n_experts_total],
          "prompt_tokens": 64, "batch": 2, "decode_steps": 3,
          "moe_calls": len(routes["cpu"]), "routing_flips": flips,
          "smallest_kth_margin": margin, "max_abs_diff_vs_cpu": worst,
          "logits_compared": flips == 0, "tolerance": 1e-4})

    for arch in ("hubert-xlarge", "internvl2-76b"):
        s = 3072
        cfg = reduced(get_config(arch)).replace(dtype="float32",
                                                quantization="none")
        if cfg.frontend == "vision_patches":
            cfg = cfg.replace(num_patches=256)
        cpu, p_cpu, gpu, p_gpu = pair(cfg)
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
            cfg, batch=2, seq=s, step=0).items() if k != "targets"}
        lc = cpu.train_logits(p_cpu, batch)
        fa.reset_launches()
        lg = gpu.train_logits(p_gpu, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        if launches != {**dict.fromkeys(launches, 0),
                        "float32": cfg.layers}:
            raise AssertionError(f"{arch}: flash launches {launches}")
        if tuple(lg.shape) != (2, s, cfg.vocab) or not bool(
                torch.isfinite(lg).all()):
            raise AssertionError(f"{arch}: logits {tuple(lg.shape)}")
        worst = float((lg.cpu() - lc).abs().max())
        if worst > 1e-4:
            raise AssertionError(f"{arch} card vs CPU: max abs diff {worst}")
        emit({"phase": "families_model", "config": cfg.name,
              "dtype": "float32", "causal": cfg.causal, "positions": s,
              "batch": 2, "flash_launches": launches,
              "max_abs_diff_vs_cpu": worst, "tolerance": 1e-4})


# (a) D = rowsum(dout * out), (b) dk / dv, (c) dq: bf16 on the tensor cores
# (the _wgmma kernels), float32 on the CUDA cores; three a call
FLASH_BWD_KERNELS = ("flash_bwd_dot_kernel", "flash_bwd_dkdv_kernel",
                     "flash_bwd_dq_kernel", "flash_bwd_dkdv_wgmma_kernel",
                     "flash_bwd_dq_wgmma_kernel")
FLASH_BWD_KERNELS_PER_CALL = 3


# (label, H, Hkv, S, d, causal, type, dout): the BitNet-1.58B train shape,
# also with dout = 2 out, and the served families' head dimensions
FLASH_BWD_SHAPES = (
    ("bitnet-1.58b train", 16, 16, 4096, 128, True, "bfloat16", "normal"),
    ("bitnet-1.58b train, dout 2 out", 16, 16, 4096, 128, True, "bfloat16",
     "2out"),
    ("bitnet-1.58b train f32", 16, 16, 1024, 128, True, "float32",
     "normal"),
    ("gqa", 32, 8, 4096, 128, True, "bfloat16", "normal"),
    ("gqa, dout 2 out", 32, 8, 4096, 128, True, "bfloat16", "2out"),
    ("granite-moe-3b-a800m", 24, 8, 4096, 64, True, "bfloat16", "normal"),
    ("hubert-xlarge", 16, 16, 4096, 80, False, "bfloat16", "normal"),
    ("zamba2-7b", 32, 32, 4096, 112, True, "bfloat16", "normal"))


def flash_bwd_bound(b, h, hkv, sq, sk, d, causal, elt, q_offset=0):
    """(bound ms, "bytes" | "operations") of the attention backward:
    ``repro_torch.kernels.cost.flash_bwd_bound`` (its five products over
    the unmasked pairs against what it must read and write once)."""
    from repro_torch.kernels.cost import flash_bwd_bound as bound

    return bound(b, h, hkv, sq, sk, d, causal, elt, q_offset)


# Each gradient is also held at the type's rtol with an atol scaled to the
# reference's own magnitude, BWD_ATOL_RMS x rms(reference): atol 2e-2 alone
# is about a median entry of dk or dv at S = 4096 and passed a kernel that
# rounds ds once to bf16.  From tools/flash_bwd_rounding.py on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md §6): dq and dk against the plain
# backward need <= 4e-4 (ds split) and 0.0098-0.136 (ds rounded once); dv,
# whose p enters its product rounded once to bf16 as in the forward
# kernel, <= 0.089; dq and dk against autograd <= 0.128, whose D uses the
# float32 output where the kernel has the bf16 one it saved; float32
# <= 1e-5.
_GRADS = [f"{g}_{r}" for g in ("dq", "dk", "dv") for r in ("plain",
                                                              "autograd")]
BWD_ATOL_RMS = {"bfloat16": {"dq_plain": 5e-3, "dk_plain": 5e-3,
                             "dv_plain": 0.15, "dq_autograd": 0.2,
                             "dk_autograd": 0.2, "dv_autograd": 0.15},
                "float32": dict.fromkeys(_GRADS, 1e-4)}
# the JAX package's custom-VJP test (float32) and bf16 flash test
FLASH_BWD_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
                 "float32": dict(rtol=2e-3, atol=2e-4)}


def flash_bwd_errors(h, hkv, s, d, causal, dtype, seed, dout="normal"):
    """The lse forward and the backward kernels once on seeded [B, S, H, d]
    values handed over as [B, H, S, d] views, as the attention layer does,
    and their errors: the output and lse against ``attention_fwd_ref``, and
    each of dq, dk, dv against ``attention_bwd_ref`` ("plain") and autograd
    through ``attention_ref`` ("autograd") on the same values, as max abs
    error and as the atol, in units of the reference's rms, that the
    type's rtol (FLASH_BWD_TOL) leaves to cover (``_atol_rms``; 0 where
    rtol covers every element).  ``dout`` is standard
    normal, or "2out": twice the kernel's output, the gradient of
    sum(out^2), whose rows of ds cancel the most.  Returns (errors, the
    operands, the lse forward's output and lse)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_ref, attention_ref,
    )

    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, s, heads, d)).astype(np.float32)).to(
            device="cuda", dtype=dtype).transpose(1, 2)
        for heads in (h, hkv, hkv, h))
    scale = 1.0 / d ** 0.5
    o, lse = fa._launch(q, k, v, causal, scale, with_lse=True)
    if dout == "2out":
        do = 2 * o
    got = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
    again = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    errs = {"repeat_equal": all(torch.equal(a, b)
                                for a, b in zip(got, again))}
    del again
    flat = lambda t: t.float().reshape(-1, s, d)              # noqa: E731
    kw = dict(q_heads=h, kv_heads=hkv, causal=causal)
    o_ref, lse_ref = attention_fwd_ref(flat(q), flat(k), flat(v), **kw)
    errs["o"] = float((flat(o) - o_ref).abs().max())
    errs["lse"] = float((lse.reshape(-1, s) - lse_ref).abs().max())
    checks = {"o": (flat(o), o_ref), "lse": (lse.reshape(-1, s), lse_ref)}
    del o_ref
    plain = attention_bwd_ref(flat(q), flat(k), flat(v), flat(o), lse_ref,
                              flat(do), **kw)
    leaves = [flat(t).requires_grad_() for t in (q, k, v)]
    attention_ref(*leaves, **kw).backward(flat(do))
    rtol = FLASH_BWD_TOL[str(dtype)[6:]]["rtol"]
    for name, g, want, auto in zip(("dq", "dk", "dv"), got, plain, leaves):
        g = g.float().reshape(want.shape)
        for ref_name, ref in (("plain", want), ("autograd", auto.grad)):
            key = f"{name}_{ref_name}"
            err = (g - ref).abs()
            errs[key] = float(err.max())
            errs[key + "_atol_rms"] = float(
                (err - rtol * ref.abs()).clamp_min(0).max()
                / ref.square().mean().sqrt())
            checks[key] = (g, ref)
    errs["_checks"] = checks
    return errs, (q, k, v, do), (o, lse)


def flash_bwd_failures(errs, dtype):
    """What a row of flash_bwd_errors fails: two calls not bit-equal, the
    output or lse off, a gradient outside the type's FLASH_BWD_TOL or
    outside its rtol with atol BWD_ATOL_RMS[key] x rms(reference)."""
    import torch

    name = str(dtype)[6:]
    out_tol = (dict(rtol=8e-3, atol=2e-5) if dtype == torch.bfloat16
               else dict(rtol=2e-4, atol=2e-5))       # as phase_flash
    fails = [] if errs["repeat_equal"] else ["two calls differ"]
    for key, (got, want) in errs["_checks"].items():
        t = (out_tol if key == "o" else dict(rtol=2e-4, atol=2e-5)
             if key == "lse" else FLASH_BWD_TOL[name])
        if not torch.allclose(got, want, **t):
            fails.append(f"{key} max abs err {errs[key]} outside {t}")
        bound = BWD_ATOL_RMS[name].get(key)
        if bound is not None and errs[key + "_atol_rms"] > bound:
            fails.append(f"{key} needs atol {errs[key + '_atol_rms']} "
                         f"rms(ref) > {bound}")
    return fails


def phase_flash_bwd():
    """The flash backward kernels against the plain backward
    (attention_bwd_ref) and against autograd through the plain forward
    (attention_ref), on the same values, at the BitNet-1.58B train shape
    (also with dout = 2 out) and at the served families' head
    dimensions."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for label, h, hkv, s, d, causal, dtype, dout in FLASH_BWD_SHAPES:
        tol = FLASH_BWD_TOL[dtype]
        dtype = getattr(torch, dtype)
        errs, (q, k, v, do), (o, lse) = flash_bwd_errors(
            h, hkv, s, d, causal, dtype, 7 * s + h + hkv + d, dout)
        fails = flash_bwd_failures(errs, dtype)
        if fails:
            raise AssertionError(f"flash_bwd {label}: {'; '.join(fails)}")
        del errs["_checks"]
        call = lambda i: fa._launch_bwd(                      # noqa: E731
            q, k, v, o, lse, do, causal, 1.0 / d ** 0.5)
        flat = lambda t: t.float().reshape(-1, s, d)          # noqa: E731
        qc, kc, vc = (t.contiguous().requires_grad_() for t in (q, k, v))
        doc = do.contiguous()
        gqa = {"enable_gqa": True} if hkv != h else {}
        # SDPA's backward alone: one forward keeps its graph, and each call
        # differentiates it again
        sdpa_out = F.scaled_dot_product_attention(qc, kc, vc,
                                                  is_causal=causal, **gqa)
        sdpa_bwd = lambda i: torch.autograd.grad(             # noqa: E731
            sdpa_out, (qc, kc, vc), doc, retain_graph=True)
        iters = 10
        bound, by = flash_bwd_bound(1, h, hkv, s, s, d, causal,
                                    2 if dtype == torch.bfloat16 else 4)
        grads = {key: v for key, v in errs.items() if key[:2] in
                 ("dq", "dk", "dv")}
        rows.append({
            "shape": label, "b": 1, "h": h, "hkv": hkv, "s": s, "d": d,
            "dtype": str(dtype)[6:], "causal": causal, "dout": dout,
            "max_abs_err": max(v for key, v in grads.items()
                               if not key.endswith("_atol_rms")),
            "errors": grads, "o_max_abs_err": errs["o"],
            "lse_max_abs_err": errs["lse"], "tolerance": tol,
            "atol_rms_bound": BWD_ATOL_RMS[str(dtype)[6:]],
            "ms": cuda_ms(call, iters),
            "device_us": device_us(call, 2, FLASH_BWD_KERNELS,
                                   per_call=FLASH_BWD_KERNELS_PER_CALL,
                                   attempts=4),
            "plain_ms": cuda_ms(lambda i: attention_bwd_ref(
                flat(q), flat(k), flat(v), flat(o), lse.reshape(-1, s),
                flat(do), q_heads=h, kv_heads=hkv, causal=causal), 2),
            "library_ms": cuda_ms(sdpa_bwd, iters),
            "library_device_us": all_device_us(sdpa_bwd, 2),
            "bound_ms": bound, "bound_by": by,
        })
        del q, k, v, do, o, lse, qc, kc, vc, doc, sdpa_out, errs
        torch.cuda.empty_cache()
    for r in rows:
        emit(dict(phase="flash_bwd", **r))
    return rows


# (label, H, Hkv, d): the BitNet-1.58B train shape, a GQA row and a d 64
# row (granite-moe-3b-a800m's heads), each causal, bf16, S = 4096 cut into
# FLASH_OFFSET_SHARDS query shards at offsets 0, 1024, 2048, 3072
FLASH_OFFSET_SHAPES = (("bitnet-1.58b train", 16, 16, 128),
                       ("gqa", 32, 8, 128),
                       ("granite-moe-3b-a800m d 64", 24, 8, 64))
FLASH_OFFSET_SEQ = 4096
FLASH_OFFSET_SHARDS = 4


def _within(got, want, rtol, atol_rms):
    """(max abs error, atol in units of rms(want) that rtol leaves to
    cover, passes): ``got`` against ``want`` at rtol with an atol of
    atol_rms x rms(want)."""
    err = (got - want).abs()
    need = float((err - rtol * want.abs()).clamp_min(0).max()
                 / want.square().mean().sqrt())
    return float(err.max()), need, need <= atol_rms


def phase_flash_offset():
    """The flash kernels with a query offset: the BitNet-1.58B train shape
    (and a GQA and a d 64 row) cut into 4 query shards of 1024, each shard
    run at its offset against the whole K / V, forward with the lse and
    backward; each shard against the plain versions at that offset, the
    joined shards against the whole-sequence kernels."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_ref, attention_ref,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    s, parts = FLASH_OFFSET_SEQ, FLASH_OFFSET_SHARDS
    n = s // parts
    tol = FLASH_BWD_TOL["bfloat16"]
    rms_bound = BWD_ATOL_RMS["bfloat16"]
    out_tol = dict(rtol=8e-3, atol=2e-5)              # as phase_flash
    # exact launches of a row's checks: the whole call and each shard,
    # forward with the lse and backward, once
    want = {name: 0 for name in fa.LAUNCHES}
    want["lse_bfloat16"] = want["backward_bfloat16"] = parts + 1
    rows = []
    for label, h, hkv, d in FLASH_OFFSET_SHAPES:
        fa.reset_launches()
        rng = np.random.default_rng(s + h + hkv + d + 1)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (1, s, heads, d)).astype(np.float32)).to(
                device="cuda", dtype=torch.bfloat16).transpose(1, 2)
            for heads in (h, hkv, hkv, h))
        scale = 1.0 / d ** 0.5
        o, lse = fa._launch(q, k, v, True, scale, with_lse=True)
        dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do, True, scale)
        sums = [torch.zeros_like(t, dtype=torch.float32) for t in (dk, dv)]
        mags = [torch.zeros_like(t, dtype=torch.float32) for t in (dk, dv)]
        flat = lambda t: t.float().reshape(-1, t.shape[2], d)  # noqa: E731
        shard_errs, fails = [], []
        joined_equal = dq_equal = True
        for r in range(parts):
            off, sl = r * n, slice(r * n, (r + 1) * n)
            qs, dos = q[:, :, sl], do[:, :, sl]
            os_, ls = fa._launch(qs, k, v, True, scale, with_lse=True,
                                 q_offset=off)
            grads = fa._launch_bwd(qs, k, v, os_, ls, dos, True, scale,
                                   q_offset=off)
            joined_equal &= bool(torch.equal(os_, o[:, :, sl])
                                 and torch.equal(ls, lse[:, :, sl]))
            dq_equal &= bool(torch.equal(grads[0], dq[:, :, sl]))
            for acc, mag, g in zip(sums, mags, grads[1:]):
                acc += g.float()
                mag += g.float().abs()
            # this shard against the plain versions at its offset
            kw = dict(q_heads=h, kv_heads=hkv, causal=True, q_offset=off)
            o_ref, lse_ref = attention_fwd_ref(flat(qs), flat(k), flat(v),
                                               **kw)
            errs = {"o": float((flat(os_) - o_ref).abs().max()),
                    "lse": float((ls.reshape(-1, n) - lse_ref).abs().max())}
            if not torch.allclose(flat(os_), o_ref, **out_tol):
                fails.append(f"shard {r} o max abs err {errs['o']}")
            if not torch.allclose(ls.reshape(-1, n), lse_ref, rtol=2e-4,
                                  atol=2e-5):
                fails.append(f"shard {r} lse max abs err {errs['lse']}")
            plain = attention_bwd_ref(flat(qs), flat(k), flat(v), flat(os_),
                                      lse_ref, flat(dos), **kw)
            del o_ref
            for name, g, ref in zip(("dq", "dk", "dv"), grads, plain):
                g = g.float().reshape(ref.shape)
                err, need, ok = _within(g, ref, tol["rtol"],
                                        rms_bound[f"{name}_plain"])
                errs[name] = err
                errs[name + "_atol_rms"] = need
                if not ok or not torch.allclose(g, ref, **tol):
                    fails.append(f"shard {r} {name} max abs err {err}, "
                                 f"atol {need} rms(ref)")
            shard_errs.append(errs)
            del plain
        # the shards' dk and dv added up against the whole call's, at the
        # bf16 tolerance; and, where the c x rms(reference) atol that a
        # kernel meets against its plain version (one rounding) does not
        # apply, since each shard rounds its partial sum to bf16 once,
        # elementwise within those roundings (half an ulp, <= 2^-8 |x|, of
        # each partial and of the whole)
        joined = {}
        for name, acc, mag, whole in zip(("dk", "dv"), sums, mags, (dk, dv)):
            whole = whole.float()
            err, need, _ = _within(acc, whole, tol["rtol"], 0.0)
            rounding = 2.0 ** -8 * (mag + whole.abs()) * 1.01 + 1e-6
            in_rounding = bool(((acc - whole).abs() <= rounding).all())
            joined[name] = {"max_abs_err": err, "atol_rms": need,
                            "within_rounding": in_rounding}
            if not (in_rounding and torch.allclose(acc, whole, **tol)):
                fails.append(f"{name} summed over shards: max abs err {err}, "
                             f"atol {need} rms(whole), within rounding "
                             f"{in_rounding}")
        if not joined_equal:
            fails.append("joined shards' output or lse differ from the whole "
                         "sequence's")
        if dict(fa.LAUNCHES) != want:
            fails.append(f"launches {dict(fa.LAUNCHES)}, want {want}")
        if fails:
            raise AssertionError(f"flash_offset {label}: {'; '.join(fails)}")
        del sums, mags

        # times: the 4 shard calls against the whole call, the plain
        # versions, SDPA with each shard's boolean offset mask
        shards = [(r * n, q[:, :, r * n:(r + 1) * n],
                   do[:, :, r * n:(r + 1) * n]) for r in range(parts)]
        fwd_lse = [fa._launch(qs, k, v, True, scale, with_lse=True,
                              q_offset=off) for off, qs, _ in shards]
        fwd = lambda i: [fa._launch(qs, k, v, True, scale,    # noqa: E731
                                    q_offset=off) for off, qs, _ in shards]
        bwd = lambda i: [fa._launch_bwd(                      # noqa: E731
            qs, k, v, ol[0], ol[1], dos, True, scale, q_offset=off)
            for (off, qs, dos), ol in zip(shards, fwd_lse)]
        plain_fwd = lambda i: [attention_ref(                 # noqa: E731
            flat(qs), flat(k), flat(v), q_heads=h, kv_heads=hkv,
            q_offset=off) for off, qs, _ in shards]
        plain_bwd = lambda i: [attention_bwd_ref(             # noqa: E731
            flat(qs), flat(k), flat(v), flat(ol[0]), ol[1].reshape(-1, n),
            flat(dos), q_heads=h, kv_heads=hkv, q_offset=off)
            for (off, qs, dos), ol in zip(shards, fwd_lse)]
        kc, vc = k.contiguous(), v.contiguous()
        gqa = {"enable_gqa": True} if hkv != h else {}
        pos = torch.arange(s, device="cuda")
        masks = [(off + pos[:n, None]) >= pos[None, :] for off, _, _ in
                 shards]
        lib_q = [qs.contiguous() for _, qs, _ in shards]
        lib_fwd = lambda i: [F.scaled_dot_product_attention(  # noqa: E731
            qq, kc, vc, attn_mask=m, **gqa) for qq, m in zip(lib_q, masks)]
        sdp_choice = getattr(torch, "_fused_sdp_choice", None)
        backend = None
        if sdp_choice is not None:
            from torch.nn.attention import SDPBackend

            backend = SDPBackend(sdp_choice(lib_q[0], kc, vc, masks[0], 0.0,
                                            False, **gqa)).name
        lib_leaves = [(qq.clone().requires_grad_(),
                       kc.clone().requires_grad_(),
                       vc.clone().requires_grad_()) for qq in lib_q]
        lib_outs = [F.scaled_dot_product_attention(a, b_, c, attn_mask=m,
                                                   **gqa)
                    for (a, b_, c), m in zip(lib_leaves, masks)]
        lib_do = [dos.contiguous() for _, _, dos in shards]
        lib_bwd = lambda i: [torch.autograd.grad(             # noqa: E731
            out, leaves, g, retain_graph=True) for out, leaves, g in
            zip(lib_outs, lib_leaves, lib_do)]
        # each shard's bound; the row is bound by what bounds its largest
        bound_f = [flash_bound(1, h, hkv, n, s, d, True, 2, off)
                   for off, _, _ in shards]
        bound_b = [flash_bwd_bound(1, h, hkv, n, s, d, True, 2, off)
                   for off, _, _ in shards]
        whole_f, whole_b = (flash_bound(1, h, hkv, s, s, d, True, 2),
                            flash_bwd_bound(1, h, hkv, s, s, d, True, 2))
        rows.append({
            "shape": label, "b": 1, "h": h, "hkv": hkv, "s": s, "d": d,
            "dtype": "bfloat16", "causal": True, "shards": parts,
            "offsets": [off for off, _, _ in shards],
            "joined_forward_bit_equal": joined_equal,
            "dq_bit_equal": dq_equal, "joined_dk_dv": joined,
            "shard_errors": shard_errs,
            "max_abs_err": max(e[key] for e in shard_errs
                               for key in ("o", "dq", "dk", "dv")),
            "tolerance": {"o": out_tol, "grads": tol,
                          "atol_rms": rms_bound},
            "forward": {
                "ms": cuda_ms(fwd, 10),
                "device_us": device_us(fwd, 2, "flash_kernel_bf16_wgmma",
                                       per_call=parts),
                "whole_ms": cuda_ms(lambda i: fa._launch(
                    q, k, v, True, scale), 10),
                "plain_ms": cuda_ms(plain_fwd, 2),
                "library_ms": cuda_ms(lib_fwd, 10),
                "library_device_us": all_device_us(lib_fwd, 2),
                "library_backend": backend,
                "bound_ms": sum(b for b, _ in bound_f),
                "bound_by": max(bound_f)[1],
                "bound_by_shard": [by for _, by in bound_f],
                "whole_bound_ms": whole_f[0]},
            "backward": {
                "ms": cuda_ms(bwd, 10),
                "device_us": device_us(bwd, 2, FLASH_BWD_KERNELS,
                                       per_call=parts
                                       * FLASH_BWD_KERNELS_PER_CALL,
                                       attempts=4),
                "whole_ms": cuda_ms(lambda i: fa._launch_bwd(
                    q, k, v, o, lse, do, True, scale), 10),
                "plain_ms": cuda_ms(plain_bwd, 2),
                "library_ms": cuda_ms(lib_bwd, 10),
                "library_device_us": all_device_us(lib_bwd, 2),
                "bound_ms": sum(b for b, _ in bound_b),
                "bound_by": max(bound_b)[1],
                "bound_by_shard": [by for _, by in bound_b],
                "whole_bound_ms": whole_b[0]},
        })
        del q, k, v, do, o, lse, dq, dk, dv, fwd_lse, lib_leaves, lib_outs
        torch.cuda.empty_cache()
    per_row = {key: n for key, n in want.items() if n}
    for r in rows:
        emit(dict(phase="flash_offset", launches_per_row=per_row, **r))
    return rows, {key: n * len(rows) for key, n in per_row.items()}


def _tree_bits_equal(a, b) -> bool:
    """Two trees of tensors equal bit for bit, leaf by leaf."""
    import torch

    from repro_torch.train.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def phase_train_model():
    """Reduced BitNet (float32, no quantization, 3072-token sequences: the
    flash path, its backward on the kernels) trains on the card against
    the CPU from the same state, then restarts after an injected crash
    through TrainingRunner and a Checkpointer under build/."""
    import shutil

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.train import (
        AdamW, Checkpointer, TrainingRunner, build_train_step,
        init_train_state,
    )
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import TrainState, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")
    s = 3072
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
    opt = AdamW(lr=1e-3)

    def on_card(seed):
        """The CPU's initial state of ``seed``, copied to the card."""
        params = params_from_jax(_numpy_tree(cpu.init(seed)))
        return TrainState(params, opt.init(params))

    state_cpu = init_train_state(cpu, opt, 0)
    state_gpu = on_card(0)

    def batch(step, device):
        return {k: torch.from_numpy(v).to(device) for k, v in
                synthetic_batch(cfg, batch=1, seq=s, step=step).items()}

    fa.reset_launches()
    l_cpu, g_cpu = value_and_grad(cpu.loss, state_cpu.params,
                                  batch(0, "cpu"))
    l_gpu, g_gpu = value_and_grad(gpu.loss, state_gpu.params,
                                  batch(0, "cuda"))
    torch.cuda.synchronize()
    grad_launches = dict(fa.LAUNCHES)
    if (grad_launches["lse_float32"], grad_launches["backward_float32"]) != (
            cfg.layers, cfg.layers):
        raise AssertionError(f"train_model grad launches {grad_launches}")
    grad_err = 0.0
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        a = a.cpu()
        grad_err = max(grad_err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-4,
                              atol=1e-5 * float(b.abs().max())):
            raise AssertionError(f"train_model grad: max abs diff "
                                 f"{float((a - b).abs().max())}")
    if abs(float(l_gpu) - float(l_cpu)) > 1e-5 * abs(float(l_cpu)):
        raise AssertionError(f"train_model loss {float(l_gpu)} on the card, "
                             f"{float(l_cpu)} on the CPU")
    losses = []
    step_cpu = build_train_step(cpu, opt)
    step_gpu = build_train_step(gpu, opt)
    for i in range(2):
        state_cpu, m_cpu = step_cpu(state_cpu, batch(i, "cpu"))
        state_gpu, m_gpu = step_gpu(state_gpu, batch(i, "cuda"))
        lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
        losses.append((lg, lc))
        if abs(lg - lc) > 1e-5 * abs(lc):
            raise AssertionError(f"train_model step {i}: loss {lg} on the "
                                 f"card, {lc} on the CPU")

    # crash at step 3, resume from the checkpoint at step 2, end at step 6
    ckpt_dir = os.path.join(ROOT, "build", "train_model_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    start = on_card(1)
    batch_fn = lambda i: batch(i, "cuda")                   # noqa: E731
    fa.reset_launches()
    crashed = TrainingRunner(step_gpu, batch_fn, start,
                             Checkpointer(ckpt_dir), ckpt_every=2)
    try:
        crashed.run(6, fail_at=3, install_signal_handler=False)
        raise AssertionError("the injected failure did not happen")
    except RuntimeError as err:
        if "injected failure at step 3" not in str(err):
            raise
    resumed = TrainingRunner(step_gpu, batch_fn, start,
                             Checkpointer(ckpt_dir), ckpt_every=2)
    resumed.run(6, install_signal_handler=False)
    straight = start
    for i in range(6):
        straight, _ = step_gpu(straight, batch_fn(i))
    torch.cuda.synchronize()
    runner_launches = dict(fa.LAUNCHES)
    if resumed.start_step != 2 or not _tree_bits_equal(resumed.state,
                                                       straight):
        raise AssertionError(f"resumed at {resumed.start_step}: not equal "
                             "bit for bit to an uninterrupted run")
    ck = Checkpointer(os.path.join(ckpt_dir, "roundtrip"))
    ck.save(6, straight, blocking=True)
    _, back = ck.restore(example=straight)
    if not _tree_bits_equal(back, straight):
        raise AssertionError("save then restore is not bit-exact")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = {"grad": grad_launches["lse_float32"]
                + grad_launches["backward_float32"],
                "lse_float32": grad_launches["lse_float32"]
                + runner_launches["lse_float32"],
                "backward_float32": grad_launches["backward_float32"]
                + runner_launches["backward_float32"]}
    emit({"phase": "train_model", "config": cfg.name, "dtype": "float32",
          "seq": s, "batch": 1, "losses_card_cpu": losses,
          "grad_max_abs_diff": grad_err,
          "tolerance": {"loss_rel": 1e-5, "grad_rtol": 1e-4,
                        "grad_atol": "1e-5 * max|g|"},
          "resume": {"fail_at": 3, "ckpt_every": 2, "start_step": 2,
                     "steps": 6, "bit_equal": True},
          "roundtrip_bit_equal": True, "flash_launches": launches})
    return launches


def traced_train_step(step, state, batch, seconds):
    """One more train step under torch.profiler, after the untraced steps
    that took ``seconds``: (state, its wall seconds, device time, the
    device's idle share against its own wall and against the untraced
    steps' mean, the ten kernels with the most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        traced_s = time.perf_counter() - t
    by_name = {}
    for evt in prof.events():
        if on_card(evt):
            name = kernel_name(evt.name) or evt.name
            by_name[name] = by_name.get(name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # the profiler slows the host, so the traced step's wall is longer than
    # an untraced one's; the device time against the untraced steps' mean
    # is the other reading of the idle share
    untraced_ms = sum(seconds[1:]) / (len(seconds) - 1) * 1e3
    return state, {
        "wall_seconds": traced_s,
        "device_ms": device_ms if by_name else None,
        "device_idle_share": (1 - device_ms / (traced_s * 1e3))
        if by_name else None,
        "idle_share_vs_untraced_step": (1 - device_ms / untraced_ms)
        if by_name else None,
        "top_device_ms": top}


def phase_train():
    """Full-width BitNet-1.58B (bf16, fake-quant with STE, remat per block)
    trains 4 steps of one 4096-token sequence through build_train_step;
    launch counts taken around the 4 steps, then one more step traced."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models.common import remat_forwards, remat_groups
    from repro_torch.train import AdamW, build_train_step, init_train_state

    cfg = get_config("bitnet-1.58b")
    if (cfg.dtype, cfg.remat, cfg.quantization) != ("bfloat16", "block",
                                                    "bitnet"):
        raise AssertionError(f"bitnet-1.58b config {cfg}")
    seq, steps = 4096, 4
    api = build_model(cfg)
    opt = AdamW(lr=TRAIN_LR)
    t0 = time.perf_counter()
    gen = torch.Generator(device=api.device)
    gen.manual_seed(0)
    state = init_train_state(api, opt, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(state.params))
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        cfg, batch=1, seq=seq, step=0).items()}
    step = build_train_step(api, opt)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, norms, seconds = [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        seconds.append(time.perf_counter() - t)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # per step: the forward calls with the lse, 3 a layer under the
    # two-level remat (the step's, its group's recomputation, its own),
    # and 32 backward calls (3 kernels each)
    want = {"lse_bfloat16": remat_forwards(cfg, cfg.layers) * steps,
            "backward_bfloat16": cfg.layers * steps}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"train flash launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")

    state, traced = traced_train_step(step, state, batch, seconds)
    emit({"phase": "train", "config": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "remat": cfg.remat,
          "remat_groups": remat_groups(cfg, cfg.layers), "batch": 1,
          "seq": seq, "steps": steps, "lr": TRAIN_LR, "init_seconds": init_s,
          "losses": losses,
          "grad_norms": norms, "step_seconds": seconds,
          "tokens_per_second": seq / (sum(seconds[1:]) / (steps - 1)),
          "peak_memory_bytes": peak, "flash_launches": got,
          "flash_kernels_per_call": {
              "forward": 1, "backward": FLASH_BWD_KERNELS_PER_CALL},
          "traced_step": traced})
    return got, measured_step(step, state, batch, peak, seconds)


def measured_step(step, state, batch, peak, seconds):
    """What phase launch holds a one-card dry run against: the peak and
    mean step seconds measured, and the FLOPs of one more step counted by
    torch's FlopCounterMode (the kernels' custom ops by their registered
    formulas), taken after every number of the phase."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        state, m = step(state, batch)
        float(m["loss"])
    seq = batch["tokens"].shape[1]
    return {"peak_memory_bytes": peak, "flops": fc.get_total_flops(),
            "step_seconds": sum(seconds[1:]) / (len(seconds) - 1),
            "seq": seq, "batch": batch["tokens"].shape[0]}


def ssm_launches(cfg, passes: int, remat: bool):
    """The SSD and flash launches ``passes`` forward-and-backward passes of
    ``cfg``'s train step make, by LAUNCHES key: a remat'd block runs its
    forward twice (once more in the backward), or three times under the
    two-level schedule (``remat_forwards``).  Mamba-2 remats its blocks
    on that schedule; the hybrid remats each period of a shared attention
    and ``attn_every`` Mamba blocks but the last (the JAX package's scan,
    models/hybrid.py)."""
    from repro_torch.models.common import remat_forwards
    from repro_torch.models.hybrid import n_attn_apps

    twice = (lambda n: 2 * n) if remat else (lambda n: n)  # noqa: E731
    if cfg.family == "ssm":
        ssd_fwd = (remat_forwards(cfg, cfg.layers) if remat
                   else cfg.layers)
        flash_fwd, apps = 0, 0
    else:
        apps = n_attn_apps(cfg)
        last = cfg.layers - (apps - 1) * cfg.attn_every
        ssd_fwd = twice(cfg.layers - last) + last
        flash_fwd = twice(apps - 1) + 1
    kind = "bfloat16" if cfg.dtype == "bfloat16" else "float32"
    want = {"ssd": {"float32": passes * ssd_fwd,
                    "backward_float32": passes * cfg.layers},
            "flash": {}}
    if apps:
        want["flash"] = {f"lse_{kind}": passes * flash_fwd,
                         f"backward_{kind}": passes * apps}
    return want


def _launch_counts():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"ssd": {k: v for k, v in ssd_ops.LAUNCHES.items() if v},
            "flash": {k: v for k, v in fa.LAUNCHES.items() if v}}


def _reset_launches():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops

    ssd_ops.reset_launches()
    fa.reset_launches()


def phase_ssm_train_model():
    """Reduced Mamba2-130m and Zamba2-7B (float32, no quantization,
    3072-token sequences, so the hybrid's attention takes the flash path)
    train on the card against the CPU from the same state: the loss within
    rel 1e-5 and every gradient leaf within rtol 1e-4 / atol 1e-5 * max|g|
    (the SSD and flash backward kernels against their plain versions), then
    2 train steps, loss within rel 1e-5; exact SSD and flash launches."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, build_train_step, init_train_state
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import TrainState, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, steps = 3072, 2
    out = {}
    for arch in ("mamba2-130m", "zamba2-7b"):
        cfg = reduced(get_config(arch)).replace(
            dtype="float32", quantization="none")
        cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
        opt = AdamW(lr=1e-3)
        state_cpu = init_train_state(cpu, opt, 0)
        params = params_from_jax(_numpy_tree(state_cpu.params))
        state_gpu = TrainState(params, opt.init(params))

        def batch(step, device):
            return {k: torch.from_numpy(v).to(device) for k, v in
                    synthetic_batch(cfg, batch=1, seq=s, step=step).items()}

        _reset_launches()
        l_cpu, g_cpu = value_and_grad(cpu.loss, state_cpu.params,
                                      batch(0, "cpu"))
        l_gpu, g_gpu = value_and_grad(gpu.loss, state_gpu.params,
                                      batch(0, "cuda"))
        torch.cuda.synchronize()
        grad_launches = _launch_counts()
        grad_err = 0.0
        for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
            a = a.cpu()
            grad_err = max(grad_err, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=1e-4,
                                  atol=1e-5 * float(b.abs().max())):
                raise AssertionError(f"ssm_train_model {arch} grad: max abs "
                                     f"diff {float((a - b).abs().max())}")
        if abs(float(l_gpu) - float(l_cpu)) > 1e-5 * abs(float(l_cpu)):
            raise AssertionError(f"ssm_train_model {arch}: loss "
                                 f"{float(l_gpu)} on the card, "
                                 f"{float(l_cpu)} on the CPU")
        losses = []
        step_cpu = build_train_step(cpu, opt)
        step_gpu = build_train_step(gpu, opt)
        for i in range(steps):
            state_cpu, m_cpu = step_cpu(state_cpu, batch(i, "cpu"))
            state_gpu, m_gpu = step_gpu(state_gpu, batch(i, "cuda"))
            lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
            losses.append((lg, lc))
            if abs(lg - lc) > 1e-5 * abs(lc):
                raise AssertionError(f"ssm_train_model {arch} step {i}: "
                                     f"loss {lg} on the card, {lc} on the "
                                     "CPU")
        torch.cuda.synchronize()
        launches = _launch_counts()
        want = ssm_launches(cfg, 1 + steps, cfg.remat != "none")
        if launches != want:
            raise AssertionError(f"ssm_train_model {arch} launches "
                                 f"{launches}, want {want}")
        want_grad = ssm_launches(cfg, 1, cfg.remat != "none")
        if grad_launches != want_grad:
            raise AssertionError(f"ssm_train_model {arch} grad launches "
                                 f"{grad_launches}, want {want_grad}")
        emit({"phase": "ssm_train_model", "config": cfg.name,
              "dtype": "float32", "layers": cfg.layers, "seq": s,
              "batch": 1, "loss_card_cpu": (float(l_gpu), float(l_cpu)),
              "losses_card_cpu": losses, "grad_max_abs_diff": grad_err,
              "tolerance": {"loss_rel": 1e-5, "grad_rtol": 1e-4,
                            "grad_atol": "1e-5 * max|g|"},
              "launches": launches})
        out[arch] = launches
    return out


# Zamba2-7B trains at full width cut to this many of its 81 layers: 1.26 B
# parameters, two applications of the shared attention (attn_every 6); the
# whole model (6.64 B) does not train on one 80 GB card (PERF.md §4)
SSM_TRAIN_ZAMBA2_LAYERS = 12
# AdamW's learning rate of each SSM train run: of 1e-5, 2e-5, 3e-5 (Zamba2,
# 12 layers) and 3e-5, 1e-4, 3e-4 (Mamba2-130m) on one repeated 4096-token
# sequence, the largest at which the loss fell at each of 6 steps; Zamba2's
# rose at its third step at 2e-5 and 3e-5 (tools/train_probe.py lr --arch
# ...; PERF.md §6)
SSM_TRAIN_LR = {"mamba2-130m": 3e-4, "zamba2-7b": 1e-5}


def phase_ssm_train():
    """Mamba2-130m at full size, then Zamba2-7B at full width and
    SSM_TRAIN_ZAMBA2_LAYERS layers (bf16, fake-quant with STE, remat per
    block), each 4 AdamW steps (lr SSM_TRAIN_LR) of one 4096-token
    sequence through build_train_step: finite losses, each below the one
    before, exact SSD and flash launches; per-step seconds, tokens/s, peak
    memory, and one more step traced."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.models.common import remat_groups
    from repro_torch.train import AdamW, build_train_step, init_train_state

    seq, steps = 4096, 4
    out, measured = {}, {}
    for cfg in (get_config("mamba2-130m"),
                get_config("zamba2-7b").replace(
                    layers=SSM_TRAIN_ZAMBA2_LAYERS)):
        if (cfg.dtype, cfg.remat, cfg.quantization) != ("bfloat16", "block",
                                                        "bitnet"):
            raise AssertionError(f"{cfg.name} config {cfg}")
        api = build_model(cfg)
        lr = SSM_TRAIN_LR[cfg.name]
        opt = AdamW(lr=lr)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=api.device)
        gen.manual_seed(0)
        state = init_train_state(api, opt, gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(state.params))
        batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
            cfg, batch=1, seq=seq, step=0).items()}
        step = build_train_step(api, opt)
        _reset_launches()
        losses, norms, seconds = [], [], []
        for _ in range(steps):
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            seconds.append(time.perf_counter() - t)
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = ssm_launches(cfg, steps, True)
        if launches != want:
            raise AssertionError(f"ssm_train {cfg.name} launches {launches}"
                                 f", want {want}")
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"ssm_train {cfg.name}: losses {losses}, "
                                 f"grad norms {norms}")
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"ssm_train {cfg.name}: loss did not fall "
                                 f"at every step: {losses}")
        state, traced = traced_train_step(step, state, batch, seconds)
        measured[cfg.name] = measured_step(step, state, batch, peak,
                                           seconds)
        emit({"phase": "ssm_train", "config": cfg.name, "params": n_params,
              "layers": cfg.layers, "d_model": cfg.d_model,
              "dtype": cfg.dtype, "remat": cfg.remat,
              "remat_groups": remat_groups(cfg, cfg.layers), "batch": 1,
              "seq": seq, "steps": steps, "lr": lr, "init_seconds": init_s,
              "losses": losses, "grad_norms": norms, "step_seconds": seconds,
              "tokens_per_second": seq / (sum(seconds[1:]) / (steps - 1)),
              "peak_memory_bytes": peak, "flops":
              measured[cfg.name]["flops"], "launches": launches,
              "traced_step": traced})
        out[cfg.name] = launches
        del api, state, step, m
    return out, measured["mamba2-130m"]


# phase launch: the dry run's one-card prediction of phase train's step
# must hold its peak memory within this share, and count its FLOPs exactly
LAUNCH_PEAK_RTOL = 0.10
# the production sweep's cells, run in LAUNCH_JOBS parallel processes (CPU
# only, beside the host-bound serving phases: start_launch_traces); the
# whole sweep (41 traced cells) took 248 s in 8 processes on the card's
# host (PR 24), so the phase runs one arch per family, train_4k on one pod
# plus its first runnable shape across two pods, at full width and at
# most LAUNCH_MAX_LAYERS layers (Zamba2-7B's train step alone traced 86 s
# at its 81), plus LAUNCH_FULL_DEPTH_CELL at its full depth, and the whole
# sweep is run on its own
# (python -m repro_torch.launch.dryrun --all; PERF.md has its table)
LAUNCH_FAMILY_ARCHS = ("qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-130m",
                       "zamba2-7b", "hubert-xlarge", "internvl2-76b")
LAUNCH_JOBS = 6
LAUNCH_MAX_LAYERS = 8
LAUNCH_FULL_DEPTH_CELL = ("qwen3-1.7b", "train_4k", "single")
# reduced cells (arch, kind, batch) on a fake (2, 2, 2) mesh, traced on
# fake tensors and run on real CPU tensors: on this host's torch the fake
# trace must count the allocations the real run makes, its peak within
# LAUNCH_REDUCED_RTOL (torch's MemTracker's reading of the real run is
# printed beside it; torch 2.11's reads higher on real tensors too, where
# torch 2.13's equals the counter's, tests/test_torch_dryrun.py).  The
# decode batch of 2 splits the KV cache along the sequence, as the
# production decode cells do
LAUNCH_REDUCED_CELLS = (("qwen3-1.7b", "train", 8),
                        ("qwen3-1.7b", "decode", 2),
                        ("mamba2-130m", "train", 8))
LAUNCH_REDUCED_RTOL = 0.01

# the one-card cells phase launch holds against the train phases' steps,
# traced at those phases' (sequence, batch)
LAUNCH_ONE_CARD_ARCHS = ("bitnet-1.58b", "mamba2-130m")
LAUNCH_TRAIN_SHAPE = (4096, 1)

_ONE_CARD_CELL = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config, shape_by_name
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch = sys.argv[2]
shape = shape_by_name("train_4k")
shape = type(shape)(shape.name, int(sys.argv[3]), int(sys.argv[4]),
                    shape.kind)
r = dryrun.run_cell(arch, "train_4k", "one", cfg=get_config(arch),
                    shape=shape,
                    mesh=make_host_mesh((1, 1), ("data", "model")))
print(json.dumps(r))
"""

_REDUCED_CELL = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
arch, kind, batch, mode = sys.argv[2:6]
r = dryrun.run_cell(arch, "tiny_" + kind, "tiny",
                    cfg=reduced(get_config(arch)).replace(remat="block"),
                    shape=ShapeConfig("tiny_" + kind, 128, int(batch), kind),
                    mesh=make_host_mesh((2, 2, 2), ("pod", "data", "model")),
                    fake=mode == "fake")
print(json.dumps(r["memory_per_device"]))
"""


def _python(*args):
    return subprocess.Popen([sys.executable, "-c", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc, what):
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"launch: {what} failed\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _run_launch_traces(out):
    """Phase launch's dry-run traces, which need no card, into ``out``:
    the one-card cells, the reduced cells fake and real and the
    full-depth cell in processes of their own at once, then the family
    sweep in LAUNCH_JOBS processes; an error is kept in ``out["error"]``
    for phase launch to raise."""
    from repro_torch.configs import applicable_shapes, get_config
    from repro_torch.launch import dryrun

    try:
        t0 = time.perf_counter()
        one_card = {arch: _python(_ONE_CARD_CELL, SRC, arch,
                                  *map(str, LAUNCH_TRAIN_SHAPE))
                    for arch in LAUNCH_ONE_CARD_ARCHS}
        reduced = {(cell, mode): _python(_REDUCED_CELL, SRC,
                                         *map(str, cell), mode)
                   for cell in LAUNCH_REDUCED_CELLS
                   for mode in ("fake", "real")}
        full_out = os.path.join(ROOT, "build", "dryrun_full_depth.json")
        if os.path.exists(full_out):
            os.remove(full_out)
        full = dryrun._cell_process(*LAUNCH_FULL_DEPTH_CELL, full_out,
                                    "bf16", 0, subprocess.PIPE)
        out["one_card"] = {arch: _result(proc, f"{arch} one-card dry run")
                           for arch, proc in one_card.items()}
        out["one_card_seconds"] = time.perf_counter() - t0
        out["reduced"] = {key: _result(proc, f"{key[0]} {key[1]}")
                          for key, proc in reduced.items()}
        full_err = full.communicate(timeout=900)[1]
        if full.returncode != 0:
            raise AssertionError(f"launch: full-depth cell failed\n"
                                 f"{full_err[-3000:]}")
        with open(full_out) as f:
            out["full"] = json.load(f)["|".join(LAUNCH_FULL_DEPTH_CELL)]

        cells = []
        for arch in LAUNCH_FAMILY_ARCHS:
            shapes = applicable_shapes(get_config(arch))
            cells.append((arch, "train_4k", "single"))
            cells.append((arch, next(s for s in shapes
                                     if shapes[s] == "run"), "multi"))
        sweep_out = os.path.join(ROOT, "build", "dryrun_launch.json")
        if os.path.exists(sweep_out):
            os.remove(sweep_out)
        t1 = time.perf_counter()
        results = dryrun.run_sweep(cells, sweep_out, jobs=LAUNCH_JOBS,
                                   max_layers=LAUNCH_MAX_LAYERS,
                                   log=lambda m: None)
        out["sweep"] = {"|".join(c): results["|".join(c)] for c in cells}
        out["sweep_seconds"] = time.perf_counter() - t1
        out["seconds"] = time.perf_counter() - t0
    except Exception as e:          # raised again by phase launch
        out["error"] = e


def start_launch_traces():
    """Start phase launch's traces in a thread beside the phases that
    follow (the host-bound serve_load first); phase launch joins it."""
    import threading

    out = {}
    thread = threading.Thread(target=_run_launch_traces, args=(out,),
                              name="launch-traces")
    thread.start()
    return thread, out


def phase_launch(train_steps, traces):
    """The dry run (repro_torch.launch.dryrun) against the card, from the
    traces ``start_launch_traces`` ran beside the earlier phases: (a) its
    predictions of phase train's and phase ssm_train's steps
    (``train_steps``: bitnet-1.58b's and mamba2-130m's train_4k cut to
    batch 1 on a one-card (data 1, model 1) mesh, each traced on fake
    tensors in a process of its own; mamba2's through the SSD kernels'
    custom ops) must each hold its phase's measured peak memory within
    LAUNCH_PEAK_RTOL and count exactly the FLOPs that FlopCounterMode
    counted on one real step; (b) the production cells
    (16 x 16 and 2 x 16 x 16 meshes, full width, depth cut to
    LAUNCH_MAX_LAYERS) of one arch per family, and LAUNCH_FULL_DEPTH_CELL
    at full depth, must each end "ok", or "skipped" with
    applicable_shapes' reason; (c) the reduced cells' fake peak must
    equal their real run's, within LAUNCH_REDUCED_RTOL."""
    from repro_torch.configs import applicable_shapes, get_config
    from repro_torch.launch import roofline

    thread, traced = traces
    thread.join()
    if "error" in traced:
        raise traced["error"]
    for arch in LAUNCH_ONE_CARD_ARCHS:
        cell = traced["one_card"][arch]
        step = train_steps[arch]
        if (step["seq"], step["batch"]) != LAUNCH_TRAIN_SHAPE:
            raise AssertionError(f"launch: {arch} measured at "
                                 f"{step['seq']} x {step['batch']}, traced "
                                 f"at {LAUNCH_TRAIN_SHAPE}")
        predicted_peak = cell["memory_per_device"]["peak_bytes_per_device"]
        measured_peak = step["peak_memory_bytes"]
        peak_err = predicted_peak / measured_peak - 1
        flops_dry, flops_card = cell["per_device"]["flops"], step["flops"]
        step_s = step["step_seconds"]
        emit({"phase": "launch", "check": "one_card",
              "cell": f"{arch}|train_4k|1x1 (batch 1)",
              "predicted_peak_bytes": predicted_peak,
              "measured_peak_bytes": measured_peak,
              "peak_rel_err": peak_err,
              "memory_per_device": cell["memory_per_device"],
              "flops_dry_run": flops_dry, "flops_flop_counter": flops_card,
              "ssd_route": cell["ssd_route"],
              "predicted_step_s": cell["predicted_step_s"],
              "t_compute": cell["t_compute"], "t_memory": cell["t_memory"],
              "bottleneck": cell["bottleneck"], "measured_step_s": step_s,
              "model_flops": cell["model_flops"],
              "model_flops_share": cell["model_flops"]
              / (roofline.PEAK_FLOPS * step_s),
              "counted_flops_share": flops_card
              / (roofline.PEAK_FLOPS * step_s),
              "trace_seconds": traced["one_card_seconds"]})
        if abs(peak_err) > LAUNCH_PEAK_RTOL:
            raise AssertionError(f"launch: {arch}: predicted peak "
                                 f"{predicted_peak} vs measured "
                                 f"{measured_peak} ({peak_err:+.3f})")
        if flops_dry != flops_card:
            raise AssertionError(f"launch: {arch}: dry-run FLOPs "
                                 f"{flops_dry} != FlopCounterMode's "
                                 f"{flops_card}")
        want_route = "kernel" if arch == "mamba2-130m" else None
        if cell["ssd_route"] != want_route:
            raise AssertionError(f"launch: {arch}: SSD route "
                                 f"{cell['ssd_route']}, want {want_route}")

    for cell in LAUNCH_REDUCED_CELLS:
        fake, real = (traced["reduced"][cell, m] for m in ("fake", "real"))
        err = fake["peak_bytes_per_device"] / real[
            "peak_bytes_per_device"] - 1
        emit({"phase": "launch", "check": "fake_vs_real",
              "cell": f"{cell[0]}|tiny_{cell[1]}|2x2x2 (reduced, batch "
                      f"{cell[2]})",
              "fake_peak_bytes": fake["peak_bytes_per_device"],
              "real_peak_bytes": real["peak_bytes_per_device"],
              "real_memtracker_peak_bytes": real["memtracker_peak_bytes"],
              "peak_rel_err": err})
        if abs(err) > LAUNCH_REDUCED_RTOL or any(
                fake[k] != real[k] for k in ("argument_bytes",
                                             "output_bytes")):
            raise AssertionError(f"launch: {cell}: fake {fake} vs "
                                 f"real {real}")

    results = dict(traced["sweep"])
    n_sweep = len(results)
    results["|".join(LAUNCH_FULL_DEPTH_CELL) + " (full depth)"] = \
        traced["full"]
    bad = {k: v.get("error", v.get("reason")) for k, v in results.items()
           if v.get("status") != "ok" and not (
               v.get("status") == "skipped" and v.get("reason")
               == applicable_shapes(get_config(k.split("|")[0]))[
                   k.split("|")[1]])}
    for key, r in results.items():
        if r.get("status") != "ok":
            emit({"phase": "launch", "cell": key, "status": r.get("status"),
                  "reason": r.get("reason"), "error": r.get("error")})
            continue
        emit({"phase": "launch", "cell": key, "status": "ok",
              **{k: r[k] for k in (
                  "chips", "hlo_flops", "hlo_bytes", "coll_bytes",
                  "coll_by_axis", "t_compute", "t_memory", "t_collective",
                  "bottleneck", "predicted_step_s", "roofline_fraction",
                  "ssd_route", "layers", "t_trace_s")},
              "peak_bytes_per_device":
              r["memory_per_device"]["peak_bytes_per_device"]})
    emit({"phase": "launch", "sweep_cells": n_sweep,
          "sweep_seconds": traced["sweep_seconds"], "jobs": LAUNCH_JOBS,
          "traces_seconds": traced["seconds"]})
    if bad:
        raise AssertionError(f"launch: cells not ok: {bad}")
    return results


# phase examples: train_bitnet's run stops at its checkpoint at
# EXAMPLES_CKPT_STEP and a second run resumes there to EXAMPLES_TRAIN_STEPS;
# serve_bitnet serves full BitNet-1.58B with EXAMPLES_SERVE_ARGS
EXAMPLES_CKPT_STEP, EXAMPLES_TRAIN_STEPS = 10, 20
EXAMPLES_SERVE_ARGS = ("--full-size", "--requests", "4", "--max-new", "8")


def _kernel_launches():
    from repro_torch.kernels.bitlinear import ops as bitlinear
    from repro_torch.kernels.block_sparse import ops as block_sparse
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd_ops

    return {"bitlinear": sum(bitlinear.LAUNCHES.values()),
            "block_sparse": sum(block_sparse.LAUNCHES.values()),
            "flash_attention": sum(n for k, n in fa.LAUNCHES.items()
                                   if not k.startswith("backward")),
            "flash_attention_bwd": sum(n for k, n in fa.LAUNCHES.items()
                                       if k.startswith("backward")),
            "ssd": ssd_ops.LAUNCHES["float32"],
            "ssd_bwd": ssd_ops.LAUNCHES["backward_float32"]}


def phase_examples():
    """The four example drivers (python -m repro_torch.examples.<name>) on
    the card, each through its main() with its printed output captured:
    sparsity_dse and quickstart whole, train_bitnet at its 100M size with
    a restart from its checkpoint, serve_bitnet at full size.  Returns
    the kernels' launches over the phase, by kernel, and the bitlinear
    kernel's by bits."""
    import contextlib
    import io
    import math
    import shutil

    import torch

    from repro_torch.examples import (
        quickstart, serve_bitnet, sparsity_dse, train_bitnet,
    )
    from repro_torch.kernels.bitlinear import ops as bitlinear
    from repro_torch.kernels.block_sparse import ops as block_sparse

    _reset_launches()
    bitlinear.reset_launches()
    block_sparse.reset_launches()
    seconds, launches = {}, {}

    def run(name, main, argv):
        before = _kernel_launches()
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            out = main(list(argv))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = {k: n - before[k] for k, n in
                          _kernel_launches().items() if n - before[k]}
        return out, text.getvalue()

    _, text = run("sparsity_dse", sparsity_dse.main, ())
    if "-> 8x16x16 selected" not in text or text.count("\n") != 16:
        raise AssertionError(f"sparsity_dse printed:\n{text}")
    _, text = run("quickstart", quickstart.main, ())
    if not text.endswith("quickstart complete.\n"):
        raise AssertionError(f"quickstart printed:\n{text[-2000:]}")
    if not (launches["quickstart"].get("bitlinear")
            and launches["quickstart"].get("block_sparse")):
        raise AssertionError(
            f"quickstart launches {launches['quickstart']}")

    ckpt = os.path.join(ROOT, "build", "examples_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    train_args = ("--ckpt-dir", ckpt, "--ckpt-every",
                  str(EXAMPLES_CKPT_STEP))
    first, _ = run("train_bitnet", train_bitnet.main,
                   ("--steps", str(EXAMPLES_CKPT_STEP)) + train_args)
    t_first = seconds["train_bitnet"]
    again, text = run("train_bitnet_restart", train_bitnet.main,
                      ("--steps", str(EXAMPLES_TRAIN_STEPS)) + train_args)
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = [first["logged"][s]["loss"] for s in sorted(first["logged"])]
    losses += [again["logged"][s]["loss"] for s in sorted(again["logged"])]
    if (first["resumed"] != 0 or again["resumed"] != EXAMPLES_CKPT_STEP
            or sorted(again["logged"]) != list(range(
                EXAMPLES_CKPT_STEP + 1, EXAMPLES_TRAIN_STEPS + 1))
            or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"train_bitnet: resumed {again['resumed']}, "
                             f"losses {losses}")

    served, _ = run("serve_bitnet", serve_bitnet.main, EXAMPLES_SERVE_ARGS)
    done = served["done"]
    if (len(done) != 4 or any(len(r.output) != 8 for r in done)
            or served["worst_error"] != 0.0):
        raise AssertionError(f"serve_bitnet: {[r.output for r in done]}, "
                             f"worst error {served['worst_error']}")
    total = {k: n for k, n in _kernel_launches().items() if n}
    emit({"phase": "examples", "launches": total, "seconds": seconds,
          "launches_by_example": launches,
          "train_bitnet": {"params": first["cfg"].param_count(),
                           "steps": EXAMPLES_TRAIN_STEPS,
                           "resumed_at": again["resumed"],
                           "losses": losses,
                           "seconds_to_checkpoint": t_first},
          "serve_bitnet": {"requests": len(done),
                           "tokens": served["tokens"],
                           "seconds": served["seconds"],
                           "decode_steps":
                           served["summary"]["decode_steps"],
                           "cycles_per_decode_token": served["summary"][
                               "cycles_per_decode_token"],
                           "worst_xval_error": served["worst_error"],
                           "kv_budget_hbm_bytes": torch.cuda
                           .get_device_properties(0).total_memory}})
    del served, first, again
    return total, dict(bitlinear.LAUNCHES)


# full-width BitNet-1.58B through the compressed step: the sequence length
# of phase train; the error-feedback state adds 2,451,868,160 x 4 B to its
# 61.1 GB peak (PERF.md §6)
TRAIN_COMPRESSED_SEQ = 4096


def _block_shapes(cfg):
    """The shapes of one layer's parameters of ``cfg`` at full width (the
    stacked [L, ...] leaves without L), from a model made on the card."""
    import torch

    from repro_torch.models import build_model

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = build_model(cfg).init(gen)
    shapes = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(f"{prefix}/{key}", node[key])
        else:
            shapes[prefix] = tuple(node.shape[1:])
    walk("blocks", params["blocks"])
    del params
    torch.cuda.empty_cache()
    return shapes


def phase_dist(gloo):
    """The distributed slice in a one-rank NCCL group on the card (NCCL
    refuses two ranks on one device): compressed_psum_pod on gradient
    leaves of BitNet-1.58B's shapes (one layer's leaves, bf16, at full
    width) equal bit for bit to the CPU's one-rank result through a gloo
    group; gpipe with one stage equal to the stage run microbatch by
    microbatch; and BitNet-1.58B's train-shape attention (1 x 4096, 16
    heads x 128, bf16) through _sdpa under use_rules(make_rules(bitnet,
    mesh(model=1), train_4k)) (_context_parallel_flash) equal to the plain
    flash path, values and gradients bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.distributed.collectives import compressed_psum_pod
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention

    if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
        raise AssertionError(f"dist: group {dist.get_backend()}, world "
                             f"{dist.get_world_size()}")
    cfg = get_config("bitnet-1.58b")
    shapes = _block_shapes(cfg)
    rng = np.random.default_rng(11)
    grads, errors = {}, {}
    for path, shape in shapes.items():
        grads[path] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
        errors[path] = torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * 1e-3)
    elements = sum(g.numel() for g in grads.values())
    t0 = time.perf_counter()
    mean_c, new_c = compressed_psum_pod(
        {k: g.cuda() for k, g in grads.items()},
        {k: e.cuda() for k, e in errors.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    mean_h, new_h = compressed_psum_pod(grads, errors, gloo)
    psum_equal = all(torch.equal(mean_c[k].cpu(), mean_h[k])
                     and torch.equal(new_c[k].cpu(), new_h[k])
                     and mean_c[k].dtype == torch.bfloat16 for k in grads)
    if not psum_equal:
        raise AssertionError("dist: compressed_psum_pod on the card differs "
                             "from the CPU's")
    del mean_c, new_c, mean_h, new_h, grads, errors

    d = cfg.d_model
    w = torch.from_numpy(rng.standard_normal((d, d), dtype=np.float32)
                         / d ** 0.5).cuda()
    b = torch.from_numpy(rng.standard_normal(d, dtype=np.float32)).cuda()
    mb = torch.from_numpy(rng.standard_normal((4, d),
                                              dtype=np.float32)).cuda()
    stage = lambda p, x: torch.tanh(x @ p[0] + p[1])          # noqa: E731
    piped = gpipe(stage, (w, b), mb)
    seq = torch.stack([stage((w, b), mb[t]) for t in range(4)])
    if not torch.equal(piped, seq):
        raise AssertionError("dist: gpipe with one stage differs from the "
                             "sequential run")

    rules = make_rules(cfg, make_host_mesh((1,), ("model",)),
                       shape_by_name("train_4k"))
    if rules.table["seq"] != "model":
        raise AssertionError(f"dist: rules {rules.table}")
    s, h, hd = 4096, cfg.n_heads, cfg.head_dim_
    base = [torch.from_numpy(rng.standard_normal((1, s, heads, hd),
                                                 dtype=np.float32)).to(
        device="cuda", dtype=torch.bfloat16)
        for heads in (h, cfg.kv_heads, cfg.kv_heads)]
    dout = torch.from_numpy(rng.standard_normal((1, s, h, hd),
                                                dtype=np.float32)).to(
        device="cuda", dtype=torch.bfloat16)
    calls = []
    real = attention._context_parallel_flash

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    fa.reset_launches()
    results = []
    for active in (rules, None):
        leaves = [t.clone().requires_grad_() for t in base]
        attention._context_parallel_flash = spy
        try:
            with use_rules(active):
                out = attention._sdpa(*leaves, causal=True)
        finally:
            attention._context_parallel_flash = real
        out.backward(dout)
        results.append([out.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}
    cp_equal = all(torch.equal(a, b_) for a, b_ in zip(*results))
    if len(calls) != 1 or not cp_equal or launches != {
            "lse_bfloat16": 2, "backward_bfloat16": 2}:
        raise AssertionError(f"dist: context-parallel calls {len(calls)}, "
                             f"equal {cp_equal}, flash launches {launches}")
    emit({"phase": "dist", "backend": "nccl", "world_size": 1,
          "compressed_psum": {"leaves": len(shapes), "elements": elements,
                              "card_seconds": card_s,
                              "equal_to_cpu": True},
          "gpipe": {"stages": 1, "microbatches": 4, "width": d,
                    "equal_to_sequential": True},
          "context_parallel": {"seq": s, "heads": h, "head_dim": hd,
                               "dtype": "bfloat16",
                               "equal_to_flash_path": True,
                               "flash_launches": launches}})
    return launches


def _hold_compressed_state(got, want, lr, steps, where):
    """The card's compressed TrainState against the CPU's after ``steps``
    steps, leaf by leaf, at phase train_model's gradient tolerances: rtol
    1e-4 and an atol of 1e-5 x the gradient's magnitude, max|p| for a
    parameter and max|g + e| = 127 scale >= 254 max|ef| for the error
    feedback (|ef| <= scale / 2).  A gradient at an int8 rounding boundary
    may quantize to the next integer on one side: 1 in 10^4 elements of a
    tree may miss the tolerance, each within the reach of one int8 step
    (2 lr a step in a parameter, two scales, 4 max|ef|, in ef), as
    tests/test_torch_distributed.py holds the gloo ranks against JAX; the
    fraction is of the whole tree, since one flip in a leaf of 64 norm
    weights is 1 in 64.  Returns the largest difference and the off
    fraction of each tree."""
    from repro_torch.train.optimizer import tree_leaves

    out = {}
    for name, a_tree, b_tree in (("params", got.params, want.params),
                                 ("ef", got.ef, want.ef)):
        worst, off, total = 0.0, 0, 0
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree),
                        strict=True):
            a, b = a.detach().cpu().double(), b.detach().double()
            top = float(b.abs().max())
            atol = 1e-5 * top * (254 if name == "ef" else 1)
            reach = 2 * lr * steps if name == "params" else 4 * top + 1e-6
            diff = (a - b).abs()
            worst = max(worst, float(diff.max()))
            off += int((diff > atol + 1e-4 * b.abs()).sum())
            total += b.numel()
            if float(diff.max()) > reach:
                raise AssertionError(
                    f"train_compressed reduced {where}: {name} leaf "
                    f"{tuple(b.shape)} max abs diff {float(diff.max())}, "
                    f"beyond one int8 step ({reach})")
        out[name] = {"max_abs_diff": worst, "off_fraction": off / total}
        if off > 1e-4 * total:
            raise AssertionError(f"train_compressed reduced {where}: {off} "
                                 f"of {total} {name} elements off")
    return out


def phase_train_compressed(gloo):
    """Full-width BitNet-1.58B trains 4 steps of one sequence through
    build_compressed_train_step in the one-rank NCCL group (the int8
    exchange with error feedback), as phase train runs; then reduced
    BitNet (float32, no quantization, 3072 tokens) through the compressed
    step on the card against the CPU (one-rank gloo group) from the same
    state, 2 steps: losses within rel 1e-5 as phase train_model holds
    them, and after each step the parameters and the error feedback
    (_hold_compressed_state)."""
    import math

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed.collectives import init_error_state
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import build_model
    from repro_torch.models.common import remat_forwards
    from repro_torch.train import AdamW, init_train_state
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import (
        TrainState, build_compressed_train_step,
    )

    cfg = get_config("bitnet-1.58b")
    seq, steps = TRAIN_COMPRESSED_SEQ, 4
    api = build_model(cfg)
    opt = AdamW(lr=TRAIN_LR)
    gen = torch.Generator(device=api.device)
    gen.manual_seed(0)
    state = init_train_state(api, opt, gen, compressed=True)
    n_params = sum(t.numel() for t in _leaves(state.params))
    ef_bytes = sum(t.numel() * t.element_size()
                   for t in tree_leaves(state.ef))
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        cfg, batch=1, seq=seq, step=0).items()}
    step = build_compressed_train_step(api, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    # the step is handed the state's last reference, so that the old
    # error-feedback state goes once exchanged (train_loop)
    box = [state]
    del state
    losses, norms, seconds, ef_nonzero = [], [], [], None
    for i in range(steps):
        t = time.perf_counter()
        new, m = step(box.pop(), batch)
        box.append(new)
        del new
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        seconds.append(time.perf_counter() - t)
        if i == 0:
            ef_nonzero = any(bool(e.abs().max() > 0)
                             for e in tree_leaves(box[0].ef))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}
    # as phase train: the two-level remat runs each layer's forward 3 times
    want = {"lse_bfloat16": remat_forwards(cfg, cfg.layers) * steps,
            "backward_bfloat16": cfg.layers * steps}
    if launches != want:
        raise AssertionError(f"train_compressed flash launches {launches}, "
                             f"want {want}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train_compressed: losses {losses}, grad "
                             f"norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_compressed: loss did not fall: "
                             f"{losses}")
    if not ef_nonzero:
        raise AssertionError("train_compressed: ef is zero after step 1")
    del box, batch, api, step
    torch.cuda.empty_cache()

    # reduced BitNet: the compressed step on the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    rcfg = reduced(get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")
    cpu, gpu = build_model(rcfg, device="cpu"), build_model(rcfg)
    ropt = AdamW(lr=1e-3)
    state_cpu = init_train_state(cpu, ropt, 0, compressed=True)
    params = params_from_jax(_numpy_tree(state_cpu.params))
    state_gpu = TrainState(params, ropt.init(params),
                           init_error_state(params))
    step_cpu = build_compressed_train_step(cpu, ropt, gloo)
    step_gpu = build_compressed_train_step(gpu, ropt)
    pairs, held = [], []
    for i in range(2):
        b = synthetic_batch(rcfg, batch=1, seq=3072, step=i)
        state_cpu, m_cpu = step_cpu(state_cpu, {
            k: torch.from_numpy(v) for k, v in b.items()})
        state_gpu, m_gpu = step_gpu(state_gpu, {
            k: torch.from_numpy(v).cuda() for k, v in b.items()})
        lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
        pairs.append((lg, lc))
        if abs(lg - lc) > 1e-5 * abs(lc):
            raise AssertionError(f"train_compressed reduced step {i}: loss "
                                 f"{lg} on the card, {lc} on the CPU")
        held.append(_hold_compressed_state(state_gpu, state_cpu, 1e-3,
                                           i + 1, f"step {i}"))
    reduced_seq = ({"reduced": {"seq": [4096, seq]}} if seq < 4096 else {})
    emit({"phase": "train_compressed", "config": cfg.name,
          "params": n_params, "dtype": cfg.dtype, "batch": 1, "seq": seq,
          **reduced_seq, "steps": steps, "lr": TRAIN_LR,
          "group": {"backend": "nccl", "world_size": 1},
          "ef_bytes": ef_bytes, "losses": losses, "grad_norms": norms,
          "step_seconds": seconds,
          "tokens_per_second": seq / (sum(seconds[1:]) / (steps - 1)),
          "peak_memory_bytes": peak, "ef_nonzero_after_step_1": True,
          "flash_launches": launches,
          "reduced_card_vs_cpu": {"config": rcfg.name, "dtype": "float32",
                                  "seq": 3072, "losses_card_cpu": pairs,
                                  "state_card_cpu": held,
                                  "tolerance": {
                                      "loss_rel": 1e-5, "rtol": 1e-4,
                                      "params_atol": "1e-5 * max|p|",
                                      "ef_atol": "1e-5 * 254 * max|ef|",
                                      "off_fraction": 1e-4,
                                      "params_reach": "2 lr x steps",
                                      "ef_reach": "4 max|ef|"}}})
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
    seconds = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__[len("phase_"):]] = time.perf_counter() - t0
        return out

    run(phase_build)
    rows = run(phase_kernel)
    run(phase_model)
    cfg, params, backend, launches = run(phase_serve)
    run(phase_window, cfg, params, backend)
    sharded_launches = run(phase_sharded, cfg, params)
    # phase launch's dry-run traces need no card: they run beside the
    # host-bound phases from serve_load on
    launch_traces = start_launch_traces()
    load_launches = run(phase_serve_load, cfg, params)
    bs_rows = run(phase_block_sparse)
    bs_launches = {"ztb": run(phase_ztb), "zoo": run(phase_zoo)}
    del params, backend                 # release BitNet-1.58B
    torch.cuda.empty_cache()
    ssd_rows = run(phase_ssd)
    ssd_bwd_rows = run(phase_ssd_bwd)
    fa_rows = run(phase_flash)
    bwd_rows = run(phase_flash_bwd)
    offset_rows, offset_launches = run(phase_flash_offset)
    torch.cuda.empty_cache()
    run(phase_hybrid_model)
    hy_launches = run(phase_hybrid_serve)
    flash_launches = {"hybrid_serve": hy_launches["flash"]}
    # each phase frees its model on return
    for phase in (phase_moe_serve, phase_encoder, phase_vlm):
        torch.cuda.empty_cache()
        flash_launches[phase.__name__[len("phase_"):]] = run(phase)
    run(phase_families_model)
    torch.cuda.empty_cache()
    train_model_launches = run(phase_train_model)
    torch.cuda.empty_cache()
    train_launches, train_step = run(phase_train)
    torch.cuda.empty_cache()
    ssm_launches_by_phase = {"ssm_train_model": run(phase_ssm_train_model)}
    torch.cuda.empty_cache()
    ssm_launches_by_phase["ssm_train"], ssm_step = run(phase_ssm_train)
    torch.cuda.empty_cache()
    run(phase_launch, {"bitnet-1.58b": train_step, "mamba2-130m": ssm_step},
        launch_traces)
    examples_launches, examples_bits = run(phase_examples)
    torch.cuda.empty_cache()
    from repro_torch.distributed import process_group

    # a one-rank NCCL group on the card (NCCL refuses two ranks on one
    # device), with a one-rank gloo group beside it for the CPU's side
    store = os.path.join(ROOT, "build", "dist_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    with process_group(store, 0, 1):
        import torch.distributed as dist

        gloo = dist.new_group([0], backend="gloo")
        dist_launches = run(phase_dist, gloo)
        torch.cuda.empty_cache()
        tc_launches = run(phase_train_compressed, gloo)
    flash_launches["train_model"] = train_model_launches["lse_float32"]
    flash_launches["train"] = train_launches["lse_bfloat16"]
    flash_launches["flash_offset"] = offset_launches["lse_bfloat16"]
    flash_launches["dist"] = dist_launches["lse_bfloat16"]
    flash_launches["train_compressed"] = tc_launches["lse_bfloat16"]
    bwd_launches = {"train_model": train_model_launches["backward_float32"],
                    "train": train_launches["backward_bfloat16"],
                    "flash_offset": offset_launches["backward_bfloat16"],
                    "dist": dist_launches["backward_bfloat16"],
                    "train_compressed": tc_launches["backward_bfloat16"]}
    # the SSM train phases' launches, summed over their two models
    ssm_sums = {phase: {kernel: {} for kernel in ("ssd", "flash")}
                for phase in ssm_launches_by_phase}
    for phase, by_arch in ssm_launches_by_phase.items():
        for counts in by_arch.values():
            for kernel, by_key in counts.items():
                for key, n in by_key.items():
                    ssm_sums[phase][kernel][key] = \
                        ssm_sums[phase][kernel].get(key, 0) + n
    for phase, sums in ssm_sums.items():
        flash_launches[phase] = sum(n for key, n in sums["flash"].items()
                                    if key.startswith("lse_"))
        bwd_launches[phase] = sum(n for key, n in sums["flash"].items()
                                  if key.startswith("backward_"))
    ssd_launches = {"hybrid_serve": hy_launches["ssd"]}
    ssd_bwd_launches = {}
    for phase, sums in ssm_sums.items():
        ssd_launches[phase] = sums["ssd"].get("float32", 0)
        ssd_bwd_launches[phase] = sums["ssd"].get("backward_float32", 0)
    # the example drivers' launches (phase examples), where they made any
    for by_phase, kernel in ((bs_launches, "block_sparse"),
                             (flash_launches, "flash_attention"),
                             (bwd_launches, "flash_attention_bwd"),
                             (ssd_launches, "ssd"),
                             (ssd_bwd_launches, "ssd_bwd")):
        if examples_launches.get(kernel):
            by_phase["examples"] = examples_launches[kernel]
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})

    # the SSD backward (3xTF32 on the tensor cores, heads in groups): the
    # counterpart of JAX's autodiff of its chunked scan, ssd_grouped_scan
    # in the JAX model's train step
    ssd_bwd_entry = {
        "name": "ssd_bwd", "route": "cuda", "ported": 22, "redesigned": 23,
        "source": "src/repro_torch/csrc/ssd_bwd.cu",
        "replaces": "src/repro/kernels/ssd/ref.py:100",
        "kernels_per_call": len(SSD_BWD_KERNELS),
        "launches": sum(ssd_bwd_launches.values()),
        "launches_by_phase": ssd_bwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in ssd_bwd_rows),
        "bit_equal": all(r["bit_equal"] for r in ssd_bwd_rows),
        "shape": {k: ssd_bwd_rows[0][k] for k in (
            "shape", "b", "h", "s", "n", "p", "chunk", "shared_bc")},
        "head_group": ssd_bwd_rows[0]["head_group"],
        "ms": ssd_bwd_rows[0]["ms"],
        "device_us": ssd_bwd_rows[0]["device_us"],
        "device_us_by_kernel": ssd_bwd_rows[0]["device_us_by_kernel"],
        "plain_ms": ssd_bwd_rows[0]["plain_ms"],
        "bound_ms": ssd_bwd_rows[0]["bound_ms"],
        "bound_by": ssd_bwd_rows[0]["bound_by"],
        "bound_f32_ms": ssd_bwd_rows[0]["bound_f32_ms"], "library_ms": None,
        "other_shapes": [{k: r[k] for k in (
            "shape", "h", "s", "n", "p", "dh_final", "head_group",
            "max_abs_err", "ms", "device_us", "device_us_by_kernel",
            "plain_ms", "bound_ms", "bound_by", "bound_f32_ms")}
            for r in ssd_bwd_rows[1:]],
    }
    head = next(r for r in rows if r["stage"] == "mlp_up" and r["m"] == 1
                and r["bits"] == 2 and not r.get("grouped"))
    stage_head = next(r for r in rows if r["stage"] == "mlp_up"
                      and r["m"] == 1 and r.get("grouped"))
    bs_head = next(r for r in bs_rows if r["stage"] == "qkv_proj"
                   and r["sparsity"] == 0.5 and r["dtype"] == "int8")
    emit({"kernels": [{
        "name": "bitlinear", "route": "cuda", "redesigned": 15,
        "source": "src/repro_torch/csrc/bitlinear.cu",
        "replaces": "src/repro/kernels/bitlinear/kernel.py:75",
        "launches": sum(launches.values()) + sum(load_launches.values())
        + sharded_launches + sum(examples_bits.values()),
        "launches_by_bits": {b: launches.get(b, 0) + load_launches.get(b, 0)
                             + (sharded_launches if b == 8 else 0)
                             + examples_bits.get(b, 0)
                             for b in sorted(set(launches)
                                             | set(load_launches)
                                             | set(examples_bits))},
        "launches_by_phase": {"serve": sum(launches.values()),
                              "serve_load": sum(load_launches.values()),
                              "sharded": sharded_launches,
                              "examples": sum(examples_bits.values())},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "shape": {k: head[k] for k in ("stage", "m", "k", "n", "bits")},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "decode_mlp_up_stage": {k: stage_head[k] for k in (
            "items", "ms", "device_us", "bound_ms", "bound_by")},
    }, {
        "name": "block_sparse", "route": "cuda", "redesigned": 15,
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
    }, {
        "name": "ssd", "route": "cuda", "redesigned": 14,
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:82",
        "launches": sum(ssd_launches.values()),
        "launches_by_phase": ssd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "shape": {k: ssd_rows[0][k] for k in ("shape", "bh", "s", "n", "p",
                                              "chunk")},
        "ms": ssd_rows[0]["ms"], "plain_ms": ssd_rows[0]["plain_ms"],
        "bound_ms": ssd_rows[0]["bound_ms"],
        "bound_by": ssd_rows[0]["bound_by"], "library_ms": None,
        # the backward's entry below, in brief
        "backward": {k: ssd_bwd_entry[k] for k in (
            "name", "launches", "ms", "bound_ms", "shape")},
    }, ssd_bwd_entry, {
        "name": "flash_attention", "route": "cuda", "redesigned": 14,
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
        "launches": sum(flash_launches.values()),
        "launches_by_phase": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in fa_rows),
        "shape": {k: fa_rows[0][k] for k in ("shape", "h", "hkv", "s", "d",
                                             "dtype")},
        "ms": fa_rows[0]["ms"], "plain_ms": fa_rows[0]["plain_ms"],
        "bound_ms": fa_rows[0]["bound_ms"],
        "bound_by": fa_rows[0]["bound_by"],
        "library_ms": fa_rows[0]["library_ms"],
        "family_shapes": [{k: r[k] for k in (
            "shape", "h", "hkv", "d", "causal", "max_abs_err", "ms",
            "device_us", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for r in fa_rows[3:]],
        "offset_rows": [dict({k: r[k] for k in (
            "shape", "h", "hkv", "s", "d", "shards", "offsets",
            "max_abs_err", "joined_forward_bit_equal")}, **{
            k: r["forward"][k] for k in (
                "ms", "device_us", "whole_ms", "plain_ms", "library_ms",
                "library_backend", "bound_ms", "bound_by")})
            for r in offset_rows],
    }, {
        "name": "flash_attention_bwd", "route": "cuda", "ported": 18,
        "redesigned": 19,
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:114",
        "kernels_per_call": FLASH_BWD_KERNELS_PER_CALL,
        "launches": sum(bwd_launches.values()),
        "launches_by_phase": bwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "shape": {k: bwd_rows[0][k] for k in ("shape", "h", "hkv", "s", "d",
                                              "dtype")},
        "ms": bwd_rows[0]["ms"], "device_us": bwd_rows[0]["device_us"],
        "plain_ms": bwd_rows[0]["plain_ms"],
        "bound_ms": bwd_rows[0]["bound_ms"],
        "bound_by": bwd_rows[0]["bound_by"],
        "library_ms": bwd_rows[0]["library_ms"],
        "library_device_us": bwd_rows[0]["library_device_us"],
        "other_shapes": [{k: r[k] for k in (
            "shape", "h", "hkv", "s", "d", "dtype", "causal", "max_abs_err",
            "ms", "device_us", "plain_ms", "library_ms",
            "library_device_us", "bound_ms", "bound_by")}
            for r in bwd_rows[1:]],
        "offset_rows": [dict({k: r[k] for k in (
            "shape", "h", "hkv", "s", "d", "shards", "offsets",
            "dq_bit_equal", "joined_dk_dv")}, **{
            k: r["backward"][k] for k in (
                "ms", "device_us", "whole_ms", "plain_ms", "library_ms",
                "library_device_us", "bound_ms", "bound_by")})
            for r in offset_rows],
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
