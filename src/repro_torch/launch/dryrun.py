"""Production dry run of the port: trace every (arch x shape x mesh) cell's
step on fake tensors in a fake world, and price it.

For each cell one process is rank 0 of a world of the mesh's size, made of
a fake process group (``torch.testing._internal.distributed.fake_pg``),
whose collectives move nothing; the parameters, optimizer moments, caches
and batch are DTensors on a ``DeviceMesh`` of the production mesh, laid
out by the sharding rules (``distributed.sharding``: ``param_shardings``,
``make_rules``), their local shards fake tensors (``FakeTensorMode``),
which hold no storage.  The step runs once, eagerly, through the port's
own entry points (``build_train_step``, ``prefill``, ``decode``) under
``device.card_trace``, so each kernel wrapper takes the card's route and
its custom op's fake implementation runs.  Around it:

    hlo_cost.CostCounter                   -> per-device FLOPs, bytes and
                                              collective bytes by mesh
                                              axis, and memory: the state
                                              and batch shards (argument),
                                              what the step returns
                                              (output), the rest at its
                                              peak (temp), and the peak;
    roofline.analyze                       -> the three roofline terms and
                                              the predicted step time.

Tracing needs no card and no CUDA build of torch: the fake tensors live on
the CPU.  Results are cached incrementally to a JSON file keyed
``arch|shape|mesh`` so that the sweep can be resumed.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import (
    ASSIGNED_ARCHS, applicable_shapes, get_config, shape_by_name,
)
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.device import card_trace
from repro_torch.distributed.sharding import (
    _fit_spec, make_rules, param_shardings, place_params, spec_placements,
    use_rules,
)
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import build_model, make_batch_spec
from repro_torch.train.optimizer import AdamW, tree_leaves
from repro_torch.train.train_loop import TrainState, build_train_step

FSDP_THRESHOLD = 3_000_000_000   # params; 2-D (fsdp x tp) weight sharding
# the fake tensors' device: any works under FakeTensorMode, and the CPU's
# needs no CUDA build of torch (autograd over fake CUDA tensors aborts in
# a CPU-only build)
TRACE_DEVICE = "cpu"


# --------------------------------------------------------------------------- #
# The fake world
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def fake_world(mesh: MeshSpec):
    """Rank 0 of a fake process group of ``mesh.size`` ranks, and a
    ``DeviceMesh`` of ``mesh`` over it; the group is destroyed on exit.  A
    process holds one group at a time: run a cell in a process of its own
    where real groups exist."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import device_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield device_mesh(mesh, TRACE_DEVICE)
    finally:
        dist.destroy_process_group()


def _batch_specs(rules, batch):
    b_ax = rules.table["batch"]
    return {k: (b_ax,) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def _cache_specs(cfg, mesh: MeshSpec, rules, cache):
    """Family-aware cache layouts, as the JAX dry run's."""
    b_ax = rules.table["batch"]
    kv_ax = rules.table["kv_heads"]
    # KV sequence axis: explicit data-sharding for long-context decode;
    # otherwise put it on "model" when the heads cannot shard (the paper's
    # KV-multicast regime; flash-decoding style sequence split)
    seq_ax = rules.table["seq"]
    if seq_ax is None and kv_ax is None and "model" in mesh.axis_names:
        seq_ax = "model"

    def assign(leaf):
        shp = leaf.shape
        if len(shp) == 5 and cfg.has_attention and shp[2] == cfg.kv_heads:
            return (None, b_ax, kv_ax, seq_ax, None)      # [L, B, Hkv, S, hd]
        if len(shp) == 5:
            return (None, b_ax, rules.table.get("ssm_heads"), None, None)
        if len(shp) == 4:
            return (None, b_ax, rules.table.get("d_inner"), None)
        return (None,) * len(shp)

    # a mesh axis that does not divide its dimension is left out (GSPMD
    # pads an uneven shard; a DTensor shard of uneven size would not match
    # the others' in local_map)
    return type(cache)(*(_fit_spec(mesh, tuple(t.shape), assign(t))
                         for t in cache))


def _place_one(t, mesh: MeshSpec, spec, dm):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, dm, spec_placements(mesh, spec),
                             src_data_rank=None)


# --------------------------------------------------------------------------- #
# Cell builders: (fn, args); a cache argument is written in place, as the
# JAX cells donate it
# --------------------------------------------------------------------------- #

def _api(cfg):
    return build_model(cfg, device=TRACE_DEVICE)


def _params(api, cfg, mesh, dm, *, fsdp: bool):
    params = api.init(torch.Generator())
    specs = param_shardings(cfg, mesh, params, fsdp=fsdp)
    return place_params(params, mesh, specs, dm), specs


def build_train_cell(cfg, shape, mesh: MeshSpec, dm) -> Tuple:
    api = _api(cfg)
    opt = AdamW(lr=1e-3)
    rules = make_rules(cfg, mesh, shape)
    fsdp = cfg.param_count() >= FSDP_THRESHOLD
    # (make_rules uses the same threshold for its in-layer param layouts)
    params, specs = _params(api, cfg, mesh, dm, fsdp=fsdp)
    # the moments are laid out as the parameters are (zeros_like)
    state = TrainState(params=params, opt=opt.init(params), ef=None)
    batch = make_batch_spec(cfg, shape, device=TRACE_DEVICE)
    batch = {k: _place_one(v, mesh, s, dm)
             for (k, v), s in zip(batch.items(),
                                  _batch_specs(rules, batch).values())}
    step = build_train_step(api, opt, grad_shardings=specs)

    def step_with_rules(state, batch):
        with use_rules(rules):
            return step(state, batch)

    return step_with_rules, (state, batch)


def build_prefill_cell(cfg, shape, mesh: MeshSpec, dm) -> Tuple:
    # serving uses offline-quantized weights (ServeEngine.prepare_params):
    # no per-step fake-quant math in the traced step
    cfg = cfg.replace(quantization="none")
    api = _api(cfg)
    rules = make_rules(cfg, mesh, shape)
    params, _ = _params(api, cfg, mesh, dm, fsdp=False)
    batch = make_batch_spec(cfg, shape, device=TRACE_DEVICE)
    batch.pop("targets", None)
    batch = {k: _place_one(v, mesh, s, dm)
             for (k, v), s in zip(batch.items(),
                                  _batch_specs(rules, batch).values())}

    if not cfg.is_decoder:
        # encoder: "prefill" = full inference forward (no cache exists)
        def fwd(params, batch):
            with use_rules(rules), torch.no_grad():
                return api.train_logits(params, batch)

        return fwd, (params, batch)

    cache = api.init_cache(shape.global_batch, shape.seq_len)
    specs = _cache_specs(cfg, mesh, rules, cache)
    cache = type(cache)(*(_place_one(t, mesh, s, dm)
                          for t, s in zip(cache, specs)))

    def prefill(params, batch, cache):
        with use_rules(rules), torch.no_grad():
            return api.prefill(params, batch, cache)

    return prefill, (params, batch, cache)


_PACKABLE = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "in_proj_z",
             "in_proj_xbc", "in_proj_dt", "out_proj", "lm_head")


def _pack_tree(params, mesh: MeshSpec, dm):
    """The packed-ternary weight format: each packable ``[.., K, N]`` bf16
    leaf becomes ``{packed: uint8 [.., K/4, N], scale: f32[]}``, the
    8x-smaller HBM payload of the paper's 2-bit mode; the packed leaf keeps
    the weight's layout, the scale is replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif (k in _PACKABLE and v.ndim >= 2 and v.shape[-2] % 4 == 0
                  and v.dtype == torch.bfloat16):
                local = v.to_local()
                shp = local.shape[:-2] + (local.shape[-2] // 4,
                                          local.shape[-1])
                packed = torch.empty(shp, dtype=torch.uint8,
                                     device=local.device)
                whole = v.shape[:-2] + (v.shape[-2] // 4, v.shape[-1])
                out[k] = {
                    "packed": DTensor.from_local(
                        packed, dm, v.placements, shape=whole,
                        stride=torch.empty(whole, device="meta").stride()),
                    "scale": DTensor.from_local(
                        torch.empty((), dtype=torch.float32,
                                    device=local.device),
                        dm, [Replicate()] * dm.ndim),
                }
            else:
                out[k] = v
        return out

    return walk(params)


def _unpack_tree(params):
    """Inverse transform inside the traced step (on the card this runs in
    the bitlinear kernel's shared memory; here it shows the packed HBM
    payload): each rank unpacks its own shard."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.quant.packing import unpack_2bit_kmajor

    def unpack(pk, scale):
        flat = pk.reshape((-1,) + tuple(pk.shape[-2:]))
        vals = torch.stack([unpack_2bit_kmajor(m) for m in flat])
        vals = vals.reshape(tuple(pk.shape[:-2])
                            + (pk.shape[-2] * 4, pk.shape[-1]))
        return vals.to(torch.bfloat16) * scale.to(torch.bfloat16)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and "packed" in v and "scale" in v:
                pk = v["packed"]
                out[k] = local_map(
                    unpack, out_placements=(pk.placements,),
                    in_placements=(pk.placements, v["scale"].placements),
                    device_mesh=pk.device_mesh)(pk, v["scale"])
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(params)


def build_decode_cell(cfg, shape, mesh: MeshSpec, dm, *,
                      weight_format: str = "bf16") -> Tuple:
    cfg = cfg.replace(quantization="none")  # see build_prefill_cell
    api = _api(cfg)
    rules = make_rules(cfg, mesh, shape)
    params, _ = _params(api, cfg, mesh, dm, fsdp=False)
    if weight_format == "packed2":
        params = _pack_tree(params, mesh, dm)
    b = shape.global_batch
    cache = api.init_cache(b, shape.seq_len)
    specs = _cache_specs(cfg, mesh, rules, cache)
    cache = type(cache)(*(_place_one(t, mesh, s, dm)
                          for t, s in zip(cache, specs)))
    token = _place_one(torch.zeros((b,), dtype=torch.int32,
                                   device=TRACE_DEVICE),
                       mesh, (rules.table["batch"],), dm)
    pos = shape.seq_len - 1

    def decode(params, token, cache):
        if weight_format == "packed2":
            params = _unpack_tree(params)
        with use_rules(rules), torch.no_grad():
            return api.decode(params, token, cache, pos)

    return decode, (params, token, cache)


def build_cell(cfg, shape, mesh: MeshSpec, dm, *,
               weight_format: str = "bf16"):
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, dm)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, dm)
    return build_decode_cell(cfg, shape, mesh, dm,
                             weight_format=weight_format)


# --------------------------------------------------------------------------- #
# Runner
# --------------------------------------------------------------------------- #

def _local_leaves(tree):
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def _own_propagation_mode():
    """DTensor learns an op's output shape by running the op on global-shape
    fake tensors under the fake mode it detects, which inside a fake trace
    is the trace's own: the memory tracker and the cost counter would take
    that for this device's work.  Here it gets a fake mode of its own
    (as in an eager run), whose ops both skip."""
    from torch.distributed.tensor import _sharding_prop

    detect = _sharding_prop.detect_fake_mode
    _sharding_prop.detect_fake_mode = lambda *a, **k: None
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode = detect


@contextlib.contextmanager
def _sync_collectives():
    """Functional collectives that wait at once, as they do on fake
    tensors (eagerly they return a tensor that waits at its first use,
    keeping their buffers until then): a real run whose memory reads as the
    fake trace's."""
    import torch.distributed._functional_collectives as funcol

    tracing = funcol._are_we_tracing
    funcol._are_we_tracing = lambda: True
    try:
        yield
    finally:
        funcol._are_we_tracing = tracing


def trace_cell(fn, args, dm, *, reference: bool = False) -> Dict[str, Any]:
    """One call of ``fn(*args)`` under the cost counter, which also tracks
    its memory (inside the caller's fake mode and fake world): its
    per-device memory split and counts.
    ``reference`` also runs torch's ``MemTracker`` and gives its peak
    (``memtracker_peak_bytes``): on real tensors, a reading to hold the
    counter's against."""
    from torch.distributed.tensor.experimental import implicit_replication

    inputs = _local_leaves(args)
    mt = contextlib.nullcontext()
    if reference:
        from torch.distributed._tools.mem_tracker import MemTracker

        mt = MemTracker()
        mt.track_external(*inputs)
    counter = hlo_cost.CostCounter(hlo_cost.axis_names(dm))
    counter.track_external(inputs)
    arg_bytes = counter.live_bytes
    with _own_propagation_mode(), mt, counter, implicit_replication(), \
            card_trace():
        out = fn(*args)
    out_bytes = counter.bytes_of(_local_leaves(out), exclude=inputs)
    peak = counter.peak_bytes
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": max(peak - arg_bytes - out_bytes, 0),
        "alias_bytes": 0,
        "peak_bytes_per_device": peak,
    }
    if reference:
        memory["memtracker_peak_bytes"] = max(
            (snap.get("Total", 0) for snap in
             mt.get_tracker_snapshot("peak").values()), default=0)
    return {"cost": counter.summary(), "memory": memory}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             weight_format: str = "bf16", cfg=None, shape=None,
             mesh: MeshSpec = None, fake: bool = True,
             max_layers: int = 0) -> Dict[str, Any]:
    """Trace one cell in a fake world of its mesh; its roofline report
    and memory as a dict.  ``cfg``, ``shape`` and ``mesh`` override the
    production ones (reduced cells in tests, the one-card check).
    ``fake=False`` runs the cell on real CPU tensors in the same fake
    world (its collectives move nothing, so values are not meaningful),
    with torch's ``MemTracker`` beside the counter: readings of a real
    run, to hold the fake one against at a size the CPU can hold.
    ``max_layers`` cuts the depth (0: none), the width kept: a quicker
    trace of the same layers."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg if cfg is not None else get_config(arch)
    if max_layers and cfg.layers > max_layers:
        cfg = cfg.replace(layers=max_layers)
    shape = shape if shape is not None else shape_by_name(shape_name)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=(mesh_name == "multi"))
    t0 = time.time()
    with fake_world(mesh) as dm, (FakeTensorMode() if fake
                                  else _sync_collectives()):
        fn, args = build_cell(
            cfg, shape, mesh, dm, weight_format=weight_format)
        t_build = time.time() - t0
        traced = trace_cell(fn, args, dm, reference=not fake)
    t_trace = time.time() - t0 - t_build
    cost = traced["cost"]
    report = rl.analyze(arch=arch, shape_name=shape_name,
                        mesh_name=mesh_name, chips=mesh.size, cost=cost,
                        cfg=cfg, shape=shape,
                        memory_stats=traced["memory"])
    out = report.to_dict()
    # the kernels' launches are charged by their own bytes: the memory
    # term is the JAX package's kernel-adjusted one already
    out["t_memory_kernel_adj"] = report.t_memory
    out["roofline_fraction_kernel_adj"] = report.roofline_fraction
    out["top_ops"] = dict(sorted(
        cost["by_op"].items(),
        key=lambda kv: -(kv[1]["flops"] / rl.PEAK_FLOPS
                         + kv[1]["bytes"] / rl.HBM_BW))[:8])
    out["by_op"] = cost["by_op"]
    # "kernel" where the step ran the SSD kernels' custom ops
    out["ssd_route"] = "kernel" if any(
        k.startswith("ssd_scan") for k in cost["by_op"]) else None
    out["per_device"] = {k: cost[k] for k in ("flops", "bytes")}
    out["layers"] = cfg.layers
    out["t_build_s"] = round(t_build, 1)
    out["t_trace_s"] = round(t_trace, 1)
    out["status"] = "ok"
    return out


def cells(multi_pod_arch=None):
    """The ``--all`` sweep in order: (arch, shape, mesh) for every assigned
    arch x shape on the single-pod mesh, then each arch's first runnable
    shape on the multi-pod mesh."""
    out = [(a, s.name, "single") for a in ASSIGNED_ARCHS for s in ALL_SHAPES]
    for a in ASSIGNED_ARCHS:
        shapes = applicable_shapes(get_config(a))
        out.append((a, next(s for s in shapes if shapes[s] == "run"),
                    "multi"))
    return out


def _key(arch: str, shape_name: str, mesh_name: str) -> str:
    return f"{arch}|{shape_name}|{mesh_name}"


def _cell_process(arch, shape_name, mesh_name, out, weight_format,
                  max_layers, stderr):
    """Start one cell in a process of its own (a fake world per process)
    writing its entry to ``out`` and its errors to ``stderr``."""
    import subprocess
    import sys

    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                             else ""))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape_name, "--mesh", mesh_name, "--out", out,
         "--weight-format", weight_format, "--max-layers", str(max_layers)],
        stdout=subprocess.DEVNULL, stderr=stderr, text=True, env=env)


def run_sweep(cells_to_run, out_path: str, *, jobs: int = 1,
              force: bool = False, weight_format: str = "bf16",
              max_layers: int = 0, log=print) -> Dict[str, Any]:
    """Every (arch, shape, mesh) of ``cells_to_run`` into the resumable JSON
    ``out_path`` (keyed ``arch|shape|mesh``): a cell ``applicable_shapes``
    skips is recorded with its reason; one that runs does so in a process
    of its own, ``jobs`` at a time, and a process that fails is recorded
    as an ``error`` entry with the end of its stderr (a failure here is a
    bug in the port).  Cells already ``ok`` are kept unless ``force``.
    Returns the results."""
    import tempfile

    results: Dict[str, Any] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    tmp = tempfile.mkdtemp(prefix="dryrun_",
                           dir=os.path.dirname(os.path.abspath(out_path)))
    pending = []
    for arch, shape_name, mesh_name in cells_to_run:
        key = _key(arch, shape_name, mesh_name)
        if results.get(key, {}).get("status") == "ok" and not force:
            log(f"[cached] {key}")
            continue
        reason = applicable_shapes(get_config(arch))[shape_name]
        if reason != "run":
            results[key] = {"status": "skipped", "reason": reason}
            log(f"[skip]   {key}: {reason}")
            continue
        pending.append((arch, shape_name, mesh_name))

    def save():
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)

    # the train cells, the longest traces, start first; a slot is refilled
    # as soon as any cell ends
    pending.sort(key=lambda c: shape_by_name(c[1]).kind != "train")
    running = []
    while pending or running:
        while pending and len(running) < max(jobs, 1):
            cell = pending.pop(0)
            out = os.path.join(tmp, _key(*cell).replace("|", "_") + ".json")
            err = open(out[:-5] + ".err", "w+")
            log(f"[run]    {_key(*cell)} ...")
            running.append((cell, out, err, _cell_process(
                *cell, out, weight_format, max_layers, err)))
        done = [r for r in running if r[3].poll() is not None]
        if not done:
            time.sleep(0.2)
            continue
        for cell, out, err, proc in done:
            running.remove((cell, out, err, proc))
            err.seek(0)
            err_text = err.read()
            err.close()
            key = _key(*cell)
            if proc.returncode == 0 and os.path.exists(out):
                with open(out) as f:
                    results[key] = json.load(f)[key]
                r = results[key]
                peak = r["memory_per_device"]["peak_bytes_per_device"]
                log(f"         ok: {key} trace={r['t_trace_s']}s "
                    f"bottleneck={r['bottleneck']} "
                    f"roofline={r['roofline_fraction']:.3f} "
                    f"peak_mem={peak / 1e9:.2f}GB")
            else:
                results[key] = {"status": "error", "error": err_text[-2000:],
                                "returncode": proc.returncode}
                log(f"         ERROR: {key}: {err_text[-400:]}")
            save()
    save()
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-arch", default="qwen3-1.7b",
                    help="kept for the JAX dry run's command line: --all "
                    "runs every arch's first runnable shape multi-pod")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--weight-format", default="bf16",
                    choices=["bf16", "packed2"],
                    help="decode-cell weight payload (packed2 = the "
                    "paper's 2-bit ternary mode, 8x smaller)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once, a process each")
    ap.add_argument("--max-layers", type=int, default=0,
                    help="cut each model's depth to this many layers "
                    "(0: the full depth), for a quicker trace")
    args = ap.parse_args()
    if args.all:
        run_sweep(cells(), args.out, jobs=args.jobs, force=args.force,
                  weight_format=args.weight_format,
                  max_layers=args.max_layers,
                  log=lambda m: print(m, flush=True))
        return
    # one cell, in this process: a failure raises (run_sweep records it)
    key = _key(args.arch, args.shape, args.mesh)
    results: Dict[str, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    reason = applicable_shapes(get_config(args.arch))[args.shape]
    if reason != "run":
        results[key] = {"status": "skipped", "reason": reason}
    elif results.get(key, {}).get("status") != "ok" or args.force:
        results[key] = run_cell(args.arch, args.shape, args.mesh,
                                weight_format=args.weight_format,
                                max_layers=args.max_layers)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({key: {k: v for k, v in results[key].items()
                            if k not in ("top_ops", "by_op")}}))


if __name__ == "__main__":
    main()
