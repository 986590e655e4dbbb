"""CPU rehearsals of chip_smoke.py's serve_load phase, at full width where
the answer depends on it and at a cut depth where memory forbids more.

    PYTHONPATH=src python3 tools/serve_load_rehearsal.py schedule
    PYTHONPATH=src python3 tools/serve_load_rehearsal.py chunk-gap --layers 2 4 8
    PYTHONPATH=src python3 tools/serve_load_rehearsal.py chunk-parity

``schedule``: the phase's engine settings (4 slots, max_seq 256, 64-token
chunks, 16 pages of 16 tokens, LiveAdmission) and its lognormal trace
(seed 2), with a LegionServeBackend at BitNet-1.58B's full width and
kernel granularity.  The backend prices shapes, not values, so its
weights are one stacked layer of random numbers (the config keeps its 32
layers) and the engine serves reduced BitNet-1.58B: the clock, and so the
schedule, is the full-width one.  Prints the load summary, the merged
steps and the bitlinear launches (counted here around the plain versions)
the replay makes.

``chunk-gap``: full-width BitNet-1.58B in bf16 at a cut depth, a
128-token prompt prefilled as 64 + 64 against the whole prefill: the max
abs difference of the last logits, and the same when the second chunk
attends from offset 0 (the fault the bf16 check on the card exists for).

``chunk-parity``: the JAX package's ``test_prefill_chunk_bit_exact``
inputs (12 tokens as chunks of 5 + 4 + 3, float32, params from
``PRNGKey(1)``) on reduced qwen3-1.7b and reduced BitNet-1.58B: the max
abs gap between chunked and whole prefill in each package (logits and
cache), and between the two packages' chunked prefills.  Needs JAX.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def schedule() -> None:
    import repro_torch.configs as configs
    from repro_torch.core import dlegion
    from repro_torch.kernels.bitlinear import ops
    from repro_torch.models import build_model
    from repro_torch.obs import SLO, lognormal_trace, run_load
    from repro_torch.serve import (
        LegionServeBackend, LiveAdmission, PagedKVCache, ServeEngine,
    )

    full = configs.get_config("bitnet-1.58b")
    small = configs.reduced(full).replace(dtype="float32")
    api = build_model(small, device="cpu")
    gen = torch.Generator().manual_seed(0)
    d, f, hd = full.d_model, full.d_ff, full.head_dim_
    rand = lambda a, b: torch.randn((1, a, b), generator=gen)  # noqa: E731
    one_layer = {"blocks": {
        "attn": {"wq": rand(d, full.n_heads * hd),
                 "wk": rand(d, full.kv_heads * hd),
                 "wv": rand(d, full.kv_heads * hd),
                 "wo": rand(full.n_heads * hd, d)},
        "mlp": {"w1": rand(d, f), "w2": rand(f, d), "w3": rand(d, f)}}}
    backend = LegionServeBackend(dlegion(8), full, one_layer, device="cpu",
                                 granularity="kernel", page_tokens=16)
    backend.check_outputs = False          # values are random: price only
    eng = ServeEngine(api, api.init(0), max_slots=4, max_seq=256,
                      prefill_chunk_tokens=64,
                      paged_kv=PagedKVCache(page_tokens=16, total_pages=16),
                      admission=LiveAdmission(backend,
                                              hbm_bytes_per_chip=80e9))
    backend.attach(eng)
    merged = []                  # (chunk shapes, decode contexts)

    def record(event):
        if event.get("chunks") and event.get("uids"):
            merged.append(([(c["tokens"], c["pos0"] + c["tokens"])
                            for c in event["chunks"]],
                           sorted(p + 1 for p in event["positions"])))
    eng.step_observers.append(record)
    plain = ops.grouped_tile_gemm

    def counted(x, w, out, slices, *, bits, **kw):
        ops.LAUNCHES[bits] += 1
        return plain(x, w, out, slices, bits=bits, **kw)
    ops.grouped_tile_gemm = counted
    _serial, step_cycles = backend.step_pipeline(4, (64,) * 4)
    trace = lognormal_trace(
        8, mean_interarrival_cycles=1.25 * step_cycles, mean_prompt=48,
        mean_output=8, max_prompt=128, max_output=12, quantum=16, seed=2)
    ops.reset_launches()
    report = run_load(eng, backend, trace,
                      slo=SLO(ttft_cycles=40.0 * step_cycles,
                              per_token_cycles=4.0 * step_cycles))
    print(json.dumps({"summary": report.summary(),
                      "engine_steps": backend.summary()["engine_steps"],
                      "merged_steps": merged,
                      "bitlinear_launches_by_bits": dict(ops.LAUNCHES)}))


def chunk_gap(layers) -> None:
    import repro_torch.configs as configs
    from repro_torch.models import build_model
    from repro_torch.serve.engine import prepare_params

    for n in layers:
        cfg = configs.get_config("bitnet-1.58b").replace(layers=n)
        api = build_model(cfg, device="cpu")
        params = prepare_params(api.init(torch.Generator().manual_seed(0)))
        prompt = torch.from_numpy(np.random.default_rng(5).integers(
            1, cfg.vocab, size=(1, 128)))
        whole, _ = api.prefill(params, {"tokens": prompt},
                               api.init_cache(1, 256))
        cache = api.init_cache(1, 256)
        _lg, cache = api.prefill_chunk(params, prompt[:, :64], cache, 0)
        part, _ = api.prefill_chunk(params, prompt[:, 64:], cache, 64)
        wrong, _ = api.prefill_chunk(params, prompt[:, 64:],
                                     api.init_cache(1, 256), 0)
        gap = [float((a.float() - whole.float()).abs().max())
               for a in (part, wrong)]
        print(json.dumps({
            "layers": n, "max_abs_diff": gap[0],
            "top1_equal": int(part.argmax()) == int(whole.argmax()),
            "logit_std": float(whole.float().std()),
            "wrong_offset_max_abs_diff": gap[1]}))


def chunk_parity() -> None:
    import jax
    import jax.numpy as jnp

    import repro_torch.configs as configs
    from repro.configs import get_config, reduced
    from repro.models import build_model as jax_build
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model

    prompt = np.arange(1, 13)[None]
    for arch, quant in (("qwen3-1.7b", "none"), ("bitnet-1.58b", "bitnet")):
        jcfg = reduced(get_config(arch)).replace(dtype="float32",
                                                 quantization=quant)
        tcfg = configs.reduced(configs.get_config(arch)).replace(
            dtype="float32", quantization=quant)
        japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
        jp = japi.init(jax.random.PRNGKey(1))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")

        def run(prefill, chunk, init, tokens):
            whole = prefill({"tokens": tokens(prompt)}, init())
            cache, pos0 = init(), 0
            for c in (5, 4, 3):
                lg, cache = chunk(tokens(prompt[:, pos0:pos0 + c]), cache,
                                  pos0)
                pos0 += c
            return [np.asarray(a) for a in (whole[0], *whole[1])], \
                [np.asarray(a) for a in (lg, *cache)]

        j_whole, j_chunk = run(
            lambda b, c: japi.prefill(jp, b, c),
            lambda t, c, p: japi.prefill_chunk(jp, t, c, p),
            lambda: japi.init_cache(1, 32),
            lambda a: jnp.asarray(a.astype(np.int32)))
        t_whole, t_chunk = run(
            lambda b, c: tapi.prefill(tp, b, c),
            lambda t, c, p: tapi.prefill_chunk(tp, t, c, p),
            lambda: tapi.init_cache(1, 32),
            lambda a: torch.from_numpy(a.astype(np.int64)))
        gap = lambda xs, ys: [float(np.abs(x - y).max())      # noqa: E731
                              for x, y in zip(xs, ys)]
        print(json.dumps({"model": arch,
                          "port_chunk_vs_whole": gap(t_chunk, t_whole),
                          "jax_chunk_vs_whole": gap(j_chunk, j_whole),
                          "port_vs_jax_chunked": gap(t_chunk, j_chunk),
                          "order": "logits, cache k, cache v"}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("schedule")
    gap = sub.add_parser("chunk-gap")
    gap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    sub.add_parser("chunk-parity")
    args = ap.parse_args()
    if args.what == "schedule":
        schedule()
    elif args.what == "chunk-gap":
        chunk_gap(args.layers)
    else:
        chunk_parity()


if __name__ == "__main__":
    main()
