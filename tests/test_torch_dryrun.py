"""The port's dry run (repro_torch.launch.dryrun) on a small fake mesh,
against the JAX package's on the same reduced cells.

Each side runs in subprocesses, at once: each port cell (fake, then on
real CPU tensors) in a process of its own, which holds its fake process
group, and the JAX cells in one that forces 8 host devices, as
tests/test_dryrun_small.py does; the test process keeps one device and no
process group.  The cells are test_dryrun_small.py's:
qwen3-1.7b, mamba2-130m and granite-moe-1b-a400m reduced, remat per block,
a 128-token train step of batch 8 on a (pod 2, data 2, model 2) mesh; the
first two also at 4 layers, where the remat takes JAX's two-level
schedule (2 groups of 2); on the port also reduced qwen3-1.7b's decode
step (a 128-token cache) and its train step at 4096 tokens, whose
attention runs the flash kernel on query shards (context parallelism).

Tolerances: per-device matmul FLOPs within 2 % of the JAX compiled step's
dot FLOPs (loop-aware, as repro.launch.hlo_cost counts them), the SSD
scan's einsums apart from the rest, and the SSD kernels' custom ops
exactly their FLOP formulas; the fake trace's peak memory within 1 % of
torch's MemTracker reading of a real CPU run of the same cell; the flash
launches' FLOPs exactly those of the sequence axis's last shard.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ["qwen3-1.7b", "mamba2-130m", "granite-moe-1b-a400m"]
# train cells held against JAX's: (arch, layers), 0 for reduced's own
JAX_CELLS = [(a, 0) for a in ARCHS] + [("qwen3-1.7b", 4),
                                       ("mamba2-130m", 4)]
# port cells: (arch, kind, tokens, batch, layers); each runs fake and on
# real tensors, but the context-parallel one (the plain attention would
# hold a 4096^2 score tile on the CPU) and the 4-layer ones only fake.
# The decode cell's batch of 2 is below the batch axes' 4 ranks, so its
# KV cache splits along the sequence, as the production decode cells' do
CELLS = [(a, "train", 128, 8, 0) for a in ARCHS] + [
    ("qwen3-1.7b", "decode", 128, 2, 0)]
DEEP_CELLS = [(a, "train", 128, 8, n) for a, n in JAX_CELLS if n]
CP_CELL = ("qwen3-1.7b", "train", 4096, 8, 0)
DEADLINE_S = 400

PORT_SCRIPT = textwrap.dedent("""
    import json, logging, sys
    sys.path.insert(0, sys.argv[1] + "/src")
    logging.disable(logging.WARNING)
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.models.common import remat_groups
    from repro_torch.models.mamba2 import _dims

    arch, mode, kind, tokens, batch, layers = sys.argv[2:8]
    cfg = reduced(get_config(arch)).replace(remat="block")
    if int(layers):
        cfg = cfg.replace(layers=int(layers))
    shape = ShapeConfig("tiny_" + kind, int(tokens), int(batch), kind)
    r = dryrun.run_cell(arch, shape.name, "tiny", cfg=cfg, shape=shape,
                        mesh=make_host_mesh((2, 2, 2), ("pod", "data",
                                                        "model")),
                        fake=mode == "fake")
    ops = r["by_op"]
    print(json.dumps({"flops": r["per_device"]["flops"],
                      "mm": ops.get("mm", {}).get("flops", 0.0),
                      "bmm": ops.get("bmm", {}).get("flops", 0.0),
                      "flash": {k: v for k, v in ops.items()
                                if k.startswith("flash")},
                      "heads": cfg.n_heads, "head_dim": cfg.head_dim_,
                      "dtype": cfg.dtype,
                      "coll_by_axis": r["coll_by_axis"],
                      "memory": r["memory_per_device"],
                      "ssd_route": r["ssd_route"],
                      "ssd": {k: v for k, v in ops.items()
                              if k.startswith("ssd_scan")},
                      "ssm_dims": _dims(cfg)[1:] + (cfg.ssd_chunk,)
                      if cfg.family == "ssm" else None,
                      "remat_groups": remat_groups(cfg, cfg.layers)}))
""")

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, re, sys
    sys.path.insert(0, sys.argv[1] + "/src")
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeConfig
    from repro.distributed.sharding import (
        make_rules, param_shardings, use_rules)
    from repro.launch import hlo_cost
    from repro.launch.mesh import make_host_mesh
    from repro.models import build_model, make_batch_spec
    from repro.train.optimizer import AdamW
    from repro.train.train_loop import TrainState, build_train_step

    # ssd_grouped_scan's einsums, named by their equations in the ops'
    # metadata
    SSD = ("bin,bjn->bij", "bhij,bhjp->bhip", "bhin,bhnp->bhip",
           "bhjn,bhjp->bhnp")

    def dots(text):
        # loop-aware dot FLOPs, the SSD scan's apart
        comps = hlo_cost.parse_module(text)
        mult = hlo_cost.computation_multipliers(comps)
        out = {"ssd": 0.0, "rest": 0.0}
        for comp in comps.values():
            local = {i.name: i for i in comp.instrs}
            for ins in comp.instrs:
                if ins.opcode in ("dot", "convolution"):
                    fam = "ssd" if any(e in ins.args for e in SSD) \
                        else "rest"
                    out[fam] += hlo_cost._dot_flops(ins, local) * mult.get(
                        comp.name, 0.0)
        return out

    mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"))
    results = {}
    for cell in sys.argv[2].split(","):
        arch, layers = cell.split(":")
        cfg = reduced(get_config(arch)).replace(remat="block")
        if int(layers):
            cfg = cfg.replace(layers=int(layers))
        shape = ShapeConfig("tiny_train", 128, 8, "train")
        api = build_model(cfg)
        opt = AdamW(lr=1e-3)
        rules = make_rules(cfg, mesh, shape)
        step = build_train_step(api, opt)

        def step_with_rules(state, batch, step=step, rules=rules):
            with use_rules(rules):
                return step(state, batch)

        shapes = jax.eval_shape(
            lambda k: TrainState(params=api.init(k),
                                 opt=opt.init(api.init(k)), ef=None),
            jax.random.PRNGKey(0))
        sh = lambda t: param_shardings(cfg, mesh, t, fsdp=True)
        state_sh = TrainState(params=sh(shapes.params), opt=type(
            shapes.opt)(step=NamedSharding(mesh, P()), mu=sh(shapes.opt.mu),
                        nu=sh(shapes.opt.nu)), ef=None)
        batch = make_batch_spec(cfg, shape)
        batch_sh = {k: NamedSharding(mesh, P(("pod", "data"),
                                             *([None] * (len(v.shape) - 1))))
                    for k, v in batch.items()}
        metrics_sh = {k: NamedSharding(mesh, P())
                      for k in ("loss", "grad_norm", "step")}
        text = jax.jit(step_with_rules, in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, metrics_sh),
                       donate_argnums=(0,)).lower(
            shapes, batch).compile().as_text()
        results[cell] = dots(text)
    print(json.dumps(results))
""")


def _wait(proc, deadline, who):
    so, se = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
    assert proc.returncode == 0, f"{who}: {se[-3000:]}"
    return json.loads(so.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX cells in one process, and each port cell, fake and real,
    in a process of its own (a process holds one fake world), all at
    once."""
    work = tmp_path_factory.mktemp("dryrun")
    # script names that shadow no package (the script's directory leads
    # sys.path)
    (work / "port_cell.py").write_text(PORT_SCRIPT)
    (work / "jax_cells.py").write_text(JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    deadline = time.monotonic() + DEADLINE_S
    start = lambda *a: subprocess.Popen(                   # noqa: E731
        [sys.executable, *map(str, a)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    procs = {"jax": start(work / "jax_cells.py", ROOT, ",".join(
        f"{a}:{n}" for a, n in JAX_CELLS))}
    runs = [(cell, mode) for cell in CELLS for mode in ("fake", "real")]
    runs += [(cell, "fake") for cell in DEEP_CELLS + [CP_CELL]]
    for cell, mode in runs:
        procs[cell, mode] = start(work / "port_cell.py", ROOT, cell[0], mode,
                                  *cell[1:])
    try:
        return {key: _wait(p, deadline, str(key))
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_cells_trace(runs, arch):
    """test_dryrun_small.py's checks on the port: FLOPs counted, the
    multi-pod step communicates across pods, and a tiny config is tiny;
    mamba2's step runs the SSD kernels' custom ops, forward and
    backward."""
    r = runs[(arch, "train", 128, 8, 0), "fake"]
    assert r["flops"] > 0
    assert r["coll_by_axis"].get("pod", 0.0) > 0, \
        "multi-pod step must communicate across pods"
    assert r["memory"]["temp_bytes"] / 1e9 < 8
    assert r["ssd_route"] == ("kernel" if arch == "mamba2-130m" else None)
    assert set(r["ssd"]) == ({"ssd_scan", "ssd_scan_bwd"}
                             if arch == "mamba2-130m" else set())


def _ssd_formulas(r, tokens: int):
    """The SSD kernels' FLOPs by their formulas at this rank's shard of
    the step: the batch over pod x data (4), the heads over model (2)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.ssd.ops import head_group

    nh, n, p, chunk = r["ssm_dims"]
    nb, nh = 8 // 4, nh // 2
    group = head_group(nb, nh, -(-tokens // chunk))
    return {"ssd_scan": cost.ssd_flops(nb, nh, tokens, n, p, chunk),
            "ssd_scan_bwd": cost.ssd_bwd_flops(nb, nh, tokens, n, p, chunk,
                                               group)}


@pytest.mark.parametrize("cell", JAX_CELLS,
                         ids=lambda c: c[0] + (f"-{c[1]}layers" if c[1]
                                               else ""))
def test_per_device_flops_match_jax(runs, cell):
    """Per-device matmul FLOPs against the JAX compiled step's dot FLOPs,
    within 2 %; the attention einsums run the same products on both sides
    at this length, so they are in the count.  qwen3 and granite-moe are
    equal, at 4 layers too, where both sides remat in two levels (2
    groups of 2 layers: each layer's forward three times, a layer's own
    recomputation without its last projection, which nothing reads).
    The one family that differs is mamba2's SSD scan: the port runs the
    kernels' custom ops, counted exactly by their formulas
    (kernels/cost.py), where JAX differentiates ssd_grouped_scan's
    einsums; the formulas count 1.108 times JAX's SSD dots at 2 layers and
    1.083 times at 4.  mamba2's projections (``mm``) equal the JAX step's
    other dots, and nothing else counts FLOPs."""
    arch, layers = cell
    port = runs[(arch, "train", 128, 8, layers), "fake"]
    jax_ = runs["jax"][f"{arch}:{layers}"]
    assert port["remat_groups"] == (2 if layers == 4 else 1)
    if arch == "mamba2-130m":
        assert port["mm"] == jax_["rest"]
        want = _ssd_formulas(port, 128)
        for name, op in port["ssd"].items():
            assert op["flops"] == op["calls"] * want[name], name
        ssd = sum(op["flops"] for op in port["ssd"].values())
        assert port["flops"] == port["mm"] + ssd
        assert port["bmm"] == 0
        assert ssd / jax_["ssd"] == pytest.approx(
            1.083 if layers else 1.108, abs=5e-4)
    else:
        assert jax_["ssd"] == 0
        assert port["flops"] == pytest.approx(jax_["rest"], rel=0.02)
        assert port["flops"] == jax_["rest"]


@pytest.mark.parametrize(
    "cell", CELLS, ids=lambda c: c[0] if c[1] == "train" else f"{c[0]}-{c[1]}")
def test_fake_peak_equals_a_real_run(runs, cell):
    """The fake trace's peak memory (the cost counter's allocations)
    against torch's MemTracker reading of the same cell on real CPU
    tensors in the same fake world, within 1 %; the argument and output
    bytes are equal, and on real tensors the counter reads as MemTracker
    does.  The decode cell writes its sharded KV cache and gathers
    across ranks, which the fake trace must count as the real run
    allocates."""
    fake, real = (runs[cell, m]["memory"] for m in ("fake", "real"))
    assert fake["peak_bytes_per_device"] == pytest.approx(
        real["memtracker_peak_bytes"], rel=0.01)
    assert real["peak_bytes_per_device"] == pytest.approx(
        real["memtracker_peak_bytes"], rel=0.01)
    for key in ("argument_bytes", "output_bytes"):
        assert fake[key] == real[key], key


def test_context_parallel_flash_is_charged_as_the_last_shard(runs):
    """Traced as rank 0, a causal query shard sees the fewest (query, key)
    pairs of its axis; the counter charges each flash launch as the last
    shard's (q_offset = 4096 - 2048), whose time the step waits for."""
    from repro_torch.kernels import cost

    r = runs[CP_CELL, "fake"]
    b, h, d = 8 // 4, r["heads"], r["head_dim"]     # batch over pod x data
    sq, sk = 4096 // 2, 4096                        # sequence over model
    elt = 2 if r["dtype"] == "bfloat16" else 4
    formula = {"flash_fwd_lse": cost.flash_flops, "flash_fwd":
               cost.flash_flops, "flash_bwd": cost.flash_bwd_flops}
    assert {"flash_fwd_lse", "flash_bwd"} <= set(r["flash"])
    for name, op in r["flash"].items():
        last = formula[name](b, h, sq, sk, d, True, elt, sk - sq)
        assert last > formula[name](b, h, sq, sk, d, True, elt, 0)
        assert op["flops"] == op["calls"] * last, name


def test_cell_list_and_skip_reasons_equal_jax():
    """The sweep's cells and skip reasons are the JAX dry run's --all keys
    (every assigned arch x shape on one pod, each arch's first runnable
    shape on two), computed from the JAX package's configs."""
    import repro.configs as jconfigs
    from repro.configs.base import ALL_SHAPES as JAX_SHAPES
    from repro_torch.configs import applicable_shapes, get_config
    from repro_torch.launch import dryrun

    want = [(a, s.name, "single") for a in jconfigs.ASSIGNED_ARCHS
            for s in JAX_SHAPES]
    for a in jconfigs.ASSIGNED_ARCHS:
        shapes = jconfigs.applicable_shapes(jconfigs.get_config(a))
        want.append((a, next(s for s in shapes if shapes[s] == "run"),
                     "multi"))
    assert dryrun.cells() == want
    assert len(want) == 50
    for arch, shape, _ in want:
        assert applicable_shapes(get_config(arch))[shape] == \
            jconfigs.applicable_shapes(jconfigs.get_config(arch))[shape]
