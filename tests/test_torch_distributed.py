"""Port parity: repro_torch.distributed (collectives, gpipe, the compressed
train step, context-parallel attention) against the JAX package, in real
``torch.distributed`` worlds on the CPU.

One JAX subprocess (4 forced host devices, as ``tests/test_pipeline.py``
runs its mesh) computes every reference, and one ``gloo`` world of 4
ranks, each its own process, computes the port's results; the two run at
the same time, and each test compares one piece.  The collectives and
the compressed step run on ranks {0, 1}, a subgroup of the world; the
context-parallel attention and the DTensor layouts on a 2 x 2 (data,
model) ``DeviceMesh`` of all 4.  Every world has its own
``file://`` store under the test's temporary directory and a timeout on
its collectives, and the harness kills a world that outlives its own
deadline, so a hung rank fails the tests instead of holding the run.

This is the counterpart of the JAX package's
``tests/test_train.py::test_compressed_psum_in_shard_map``, which skips
whenever the test process has one JAX device.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
LR = 1e-3
STEPS = 2
TRAIN_SEQ = 64
DEADLINE_S = 300

LEAVES = {"a": (8,), "b": (3, 5), "c": (64, 32)}


def _inputs(rng):
    """Seeded inputs of every piece, as numpy arrays."""
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {}
    for m in (0, 1):
        for name, shape in LEAVES.items():
            out[f"g{m}_{name}"] = arr(*shape) * (m + 1)
            out[f"e{m}_{name}"] = arr(*shape) * 1e-2
    out["ws"] = arr(4, 8, 8) * 0.3
    out["bs"] = arr(4, 8)
    out["mb"] = arr(6, 8)
    # context-parallel flash: B 1, S 512, H 4 / Hkv 2, d 32, [B, S, H, d]
    out["q"], out["k"], out["v"] = arr(1, 512, 4, 32), arr(1, 512, 2, 32), \
        arr(1, 512, 2, 32)
    out["dout"] = arr(1, 512, 4, 32)
    return out


def _train_cfg(configs):
    return configs.reduced(configs.get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    root, inputs, ckpt = sys.argv[1:4]
    sys.path.insert(0, root + "/src")
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    import repro.configs as configs
    from repro.compat import make_mesh, shard_map
    from repro.data import synthetic_batch
    from repro.distributed import collectives
    from repro.distributed.pipeline import gpipe
    from repro.distributed.sharding import Rules
    from repro.models import build_model
    from repro.models.attention import _context_parallel_flash, _flash_ref
    from repro.train import AdamW, Checkpointer
    from repro.train.train_loop import (
        build_compressed_train_step, init_train_state)

    inp = np.load(inputs)
    names = sorted(k[3:] for k in inp.files if k.startswith("g0_"))
    out = {}
    # collectives: each member's compression, and the 2-member psum
    for m in (0, 1):
        for n in names:
            q, s, e = collectives.compress_with_feedback(
                jnp.asarray(inp[f"g{m}_{n}"]), jnp.asarray(inp[f"e{m}_{n}"]))
            out[f"q{m}_{n}"], out[f"scale{m}_{n}"] = q, s
            out[f"newe{m}_{n}"] = e
    pod = make_mesh((2,), ("pod",), devices=jax.devices()[:2])
    g = {n: jnp.stack([inp[f"g0_{n}"], inp[f"g1_{n}"]]) for n in names}
    e = {n: jnp.stack([inp[f"e0_{n}"], inp[f"e1_{n}"]]) for n in names}

    def psum(g, e):
        mean, ne = collectives.compressed_psum_pod(
            {n: g[n][0] for n in names}, {n: e[n][0] for n in names}, "pod")
        return ({n: mean[n][None] for n in names},
                {n: ne[n][None] for n in names})

    mean, _ = shard_map(psum, mesh=pod, in_specs=(P("pod"), P("pod")),
                        out_specs=(P("pod"), P("pod")))(g, e)
    for n in names:
        out[f"mean_{n}"] = mean[n]
    # gpipe: 4 stages of tanh(x w + b) over 6 microbatches
    stages = make_mesh((4,), ("stage",))
    stage = lambda p, x: jnp.tanh(x @ p[0] + p[1])
    ws, bs, mb = (jnp.asarray(inp[n]) for n in ("ws", "bs", "mb"))
    out["gpipe"] = gpipe(stage, (ws, bs), mb, mesh=stages, axis="stage")
    out["gpipe_dws"], out["gpipe_dbs"], out["gpipe_dmb"] = jax.grad(
        lambda ws, bs, mb: (gpipe(stage, (ws, bs), mb, mesh=stages,
                                  axis="stage") ** 2).sum(),
        argnums=(0, 1, 2))(ws, bs, mb)
    # context-parallel flash on a 2-device "model" axis, and the VJP of
    # the whole-sequence flash
    model = make_mesh((2,), ("model",), devices=jax.devices()[:2])
    rules = Rules(model, {"seq": "model", "batch": None})
    q, k, v, dout = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "dout"))
    out["cp_out"] = _context_parallel_flash(q, k, v, causal=True,
                                            rules=rules)
    o, vjp = jax.vjp(lambda q, k, v: _flash_ref(q, k, v, causal=True),
                     q, k, v)
    out["flash_out"] = o
    out["dq"], out["dk"], out["dv"] = vjp(dout)
    # the compressed train step, reduced BitNet in float32, 2 pods
    cfg = configs.reduced(configs.get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")
    api = build_model(cfg)
    opt = AdamW(lr=float(sys.argv[4]))
    state = init_train_state(api, opt, jax.random.PRNGKey(0),
                             compressed=True)
    Checkpointer(ckpt + "/init").save(0, state, blocking=True)
    step = build_compressed_train_step(api, opt, pod, pod_axis="pod")
    for i in range(int(sys.argv[5])):
        batch = {kk: jnp.asarray(vv) for kk, vv in synthetic_batch(
            cfg, batch=2, seq=int(sys.argv[6]), step=i).items()}
        state, metrics = step(state, batch)
        out[f"loss{i}"] = metrics["loss"]
        out[f"grad_norm{i}"] = metrics["grad_norm"]
    Checkpointer(ckpt + "/final").save(int(sys.argv[5]), state,
                                       blocking=True)
    # ef leaves under a replicated out-spec hold each pod's own residual on
    # that pod's device; a host read (the checkpoint) sees pod 0's
    for i, leaf in enumerate(jax.tree.leaves(state.ef)):
        by_dev = {sh.device: sh.data for sh in leaf.addressable_shards}
        out[f"ef_pod1_{i}"] = by_dev[jax.devices()[1]]
    np.savez(ckpt + "/jax.npz", **{kk: np.asarray(vv)
                                   for kk, vv in out.items()})
    print("JAX OK")
""")


WORKER_SCRIPT = textwrap.dedent("""
    import sys
    from types import SimpleNamespace
    root, rank, world, store, inputs, work = sys.argv[1:7]
    lr, steps, seq = float(sys.argv[7]), int(sys.argv[8]), int(sys.argv[9])
    rank, world = int(rank), int(world)
    sys.path.insert(0, root + "/src")
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.data import synthetic_batch
    from repro_torch.distributed import process_group
    from repro_torch.distributed.collectives import (
        compress_with_feedback, compressed_psum_pod)
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.distributed.sharding import (
        Rules, constrain_layer_params, make_rules, redistribute, use_rules)
    from repro_torch.launch.mesh import device_mesh, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.attention import _context_parallel_flash
    from repro_torch.train import AdamW, Checkpointer
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_loop import (
        TrainState, build_compressed_train_step, build_train_step)

    inp = np.load(inputs)
    t = lambda a: torch.from_numpy(np.array(a))
    names = sorted(k[3:] for k in inp.files if k.startswith("g0_"))
    res = {}
    with process_group(store, rank, world, device="cpu", timeout_s=60):
        pair = dist.new_group([0, 1])
        # DTensor layouts from specs on a 2 x 2 mesh of the 4 ranks
        from torch.distributed.tensor import Replicate, distribute_tensor
        dm = device_mesh(make_host_mesh((2, 2), ("data", "model")), "cpu")
        full = distribute_tensor(torch.arange(32.0).reshape(4, 8), dm,
                                 [Replicate(), Replicate()])
        res["local_dm"] = np.array(redistribute(
            full, ("data", "model")).to_local().shape)
        res["local_m"] = np.array(redistribute(
            full, (None, "model")).to_local().shape)
        # context-parallel flash over the model axis of the 2 x 2 mesh
        # (ranks {0, 1} and {2, 3}), values and gradients
        rules = Rules(make_host_mesh((2, 2), ("data", "model")),
                      {"seq": "model", "batch": None})
        q, k, v = (t(inp[n]).requires_grad_() for n in "qkv")
        out = _context_parallel_flash(q, k, v, causal=True, rules=rules)
        out.backward(t(inp["dout"]))
        res["cp_out"] = out.detach().numpy()
        res["dq"], res["dk"], res["dv"] = (x.grad.numpy() for x in (q, k, v))
        # a reduced BitNet's loss and gradients on DTensor parameters
        # placed by place_params on the 2 x 2 mesh, against the plain run
        from torch.distributed.tensor import Shard
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.distributed.sharding import (
            param_shardings, place_params)
        from repro_torch.train.optimizer import tree_leaves
        from repro_torch.train.train_loop import value_and_grad
        mesh22 = make_host_mesh((2, 2), ("data", "model"))
        cfg_d = configs.reduced(configs.get_config("bitnet-1.58b")).replace(
            dtype="float32", quantization="none")
        api_d = build_model(cfg_d, device="cpu")
        params = api_d.init(0)
        batch_d = {kk: torch.from_numpy(vv) for kk, vv in synthetic_batch(
            cfg_d, batch=2, seq=seq, step=0).items()}
        loss_p, grads_p = value_and_grad(api_d.loss, params, batch_d)
        placed = place_params(params, mesh22, param_shardings(
            cfg_d, mesh22, params, fsdp=True), dm)
        batch_dt = {kk: distribute_tensor(vv, dm, [Shard(0), Replicate()])
                    for kk, vv in batch_d.items()}
        with use_rules(make_rules(cfg_d, mesh22, ShapeConfig(
                "t", seq, 2, "train"))), implicit_replication():
            loss_d, grads_d = value_and_grad(api_d.loss, placed, batch_dt)
        res["dt_loss"], res["plain_loss"] = (
            loss_d.full_tensor().numpy(), loss_p.numpy())
        for i, (gd, gp) in enumerate(zip(tree_leaves(grads_d),
                                         tree_leaves(grads_p))):
            res[f"dt_grad{i}"] = gd.full_tensor().numpy()
            res[f"plain_grad{i}"] = gp.numpy()
        res["dt_placed"] = np.array(sum(
            any(pl.is_shard() for pl in t.placements)
            for t in tree_leaves(placed)))
        # DTensor gradients through build_train_step(grad_shardings=...),
        # and one layer's DTensor parameters through constrain_layer_params
        class Api:
            def loss(self, params, batch):
                return (params["w"] ** 2).sum()

        class Record:
            def update(self, grads, opt, params):
                g = grads["w"]
                res["grad_placements"] = np.array(str(tuple(g.placements)))
                res["grad_local"] = g.to_local().numpy()
                res["grad_full"] = g.full_tensor().numpy()
                return params, opt, torch.zeros(())

        build_train_step(Api(), Record(), grad_shardings={
            "w": ("data", "model")})(TrainState(
                {"w": full}, SimpleNamespace(step=0)), {})
        cfg = configs.reduced(configs.get_config("bitnet-1.58b"))
        layer = {"attn": {"wq": distribute_tensor(
            torch.ones(cfg.d_model, cfg.n_heads * cfg.head_dim_), dm,
            [Replicate(), Replicate()]), "k_norm": torch.ones(4)}}
        with use_rules(make_rules(cfg, make_host_mesh((2, 2), (
                "data", "model")), configs.shape_by_name("train_4k"))):
            laid = constrain_layer_params(layer)
        res["wq_placements"] = np.array(str(tuple(
            laid["attn"]["wq"].placements)))
        res["k_norm_plain"] = np.array(laid["attn"]["k_norm"] is
                                       layer["attn"]["k_norm"])
        # gpipe: stage `rank` of 4, and its gradient
        w, b, mb = (t(inp["ws"][rank]).requires_grad_(),
                    t(inp["bs"][rank]).requires_grad_(),
                    t(inp["mb"]).requires_grad_())
        out = gpipe(lambda p, x: torch.tanh(x @ p[0] + p[1]), (w, b), mb)
        (out ** 2).sum().backward()
        res["gpipe"] = out.detach().numpy()
        res["gpipe_dw"], res["gpipe_db"], res["gpipe_dmb"] = (
            w.grad.numpy(), b.grad.numpy(), mb.grad.numpy())
        if rank < 2:
            g = {n: t(inp[f"g{rank}_{n}"]) for n in names}
            e = {n: t(inp[f"e{rank}_{n}"]) for n in names}
            for n in names:
                q, s, ne = compress_with_feedback(g[n], e[n])
                res[f"q_{n}"], res[f"scale_{n}"] = q.numpy(), s.numpy()
                res[f"newe_{n}"] = ne.numpy()
            mean, new_e = compressed_psum_pod(g, e, pair)
            for n in names:
                res[f"mean_{n}"] = mean[n].numpy()
                res[f"psum_newe_{n}"] = new_e[n].numpy()
            # the compressed train step from the JAX package's state
            cfg = configs.reduced(configs.get_config(
                "bitnet-1.58b")).replace(dtype="float32",
                                         quantization="none")
            api = build_model(cfg, device="cpu")
            _, tree = Checkpointer(work + "/init").restore(device="cpu")
            state = TrainState(tree[0], AdamWState(*tree[1]), tree[2])
            step = build_compressed_train_step(api, AdamW(lr=lr), pair)
            for i in range(steps):
                batch = {kk: torch.from_numpy(vv) for kk, vv in
                         synthetic_batch(cfg, batch=2, seq=seq,
                                         step=i).items()}
                state, metrics = step(state, batch)
                res[f"loss{i}"] = metrics["loss"].numpy()
                res[f"grad_norm{i}"] = metrics["grad_norm"].numpy()
            Checkpointer(f"{work}/port{rank}").save(steps, state,
                                                    blocking=True)
        dist.barrier()
    np.savez(f"{work}/rank{rank}.npz", **res)
    print("RANK OK", rank)
""")


def _wait_all(procs, deadline):
    """Wait for every process until ``deadline`` (time.monotonic()); kill
    them all if it passes.  Returns [(returncode, stdout, stderr)]."""
    out = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 0.1)
            so, se = p.communicate(timeout=left)
            out.append((p.returncode, so, se))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a world outlived its {DEADLINE_S} s deadline")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's 4-rank gloo world, run at once."""
    import jax

    import repro.configs as jconfigs
    from repro.models import build_model as jax_build
    from repro.train import AdamW as JaxAdamW
    from repro.train import Checkpointer as JaxCheckpointer
    from repro.train.train_loop import init_train_state as jax_init

    work = tmp_path_factory.mktemp("dist")
    inputs = work / "inputs.npz"
    np.savez(inputs, **_inputs(np.random.default_rng(0)))
    # the initial compressed state, written by the JAX package for both
    cfg = _train_cfg(jconfigs)
    state = jax_init(jax_build(cfg), JaxAdamW(lr=LR), jax.random.PRNGKey(0),
                     compressed=True)
    JaxCheckpointer(str(work / "init")).save(0, state, blocking=True)
    (work / "jax_ckpt").mkdir()
    jax_py, worker_py = work / "jax_ref.py", work / "worker.py"
    jax_py.write_text(JAX_SCRIPT)
    worker_py.write_text(WORKER_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    deadline = time.monotonic() + DEADLINE_S
    procs = [subprocess.Popen(
        [sys.executable, str(jax_py), ROOT, str(inputs),
         str(work / "jax_ckpt"), str(LR), str(STEPS), str(TRAIN_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)]
    store = work / "store"
    procs += [subprocess.Popen(
        [sys.executable, str(worker_py), ROOT, str(r), str(WORLD),
         str(store), str(inputs), str(work), str(LR), str(STEPS),
         str(TRAIN_SEQ)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    results = _wait_all(procs, deadline)
    for (rc, so, se), who in zip(results, ["jax"] + [
            f"rank {r}" for r in range(WORLD)]):
        assert rc == 0, f"{who}: {se[-3000:]}"
    return {"jax": dict(np.load(work / "jax_ckpt" / "jax.npz")),
            "ranks": [dict(np.load(work / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "work": work}


def test_compression_equals_jax_per_member(runs):
    """Each member's int8 payload and scale equal JAX's
    compress_with_feedback bit for bit; its new error within float32
    rounding."""
    jax_out = runs["jax"]
    for m in (0, 1):
        got = runs["ranks"][m]
        for n in LEAVES:
            np.testing.assert_array_equal(got[f"q_{n}"], jax_out[f"q{m}_{n}"])
            np.testing.assert_array_equal(got[f"scale_{n}"],
                                          jax_out[f"scale{m}_{n}"])
            np.testing.assert_allclose(got[f"newe_{n}"],
                                       jax_out[f"newe{m}_{n}"], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_array_equal(got[f"psum_newe_{n}"],
                                          got[f"newe_{n}"])


def test_compressed_psum_on_two_ranks(runs):
    """The 2-rank compressed mean equals JAX's psum and both ranks agree;
    it is within JAX's own 2 % of the true mean (the JAX test that skips
    on one device)."""
    inp = _inputs(np.random.default_rng(0))
    for n in LEAVES:
        a, b = runs["ranks"][0][f"mean_{n}"], runs["ranks"][1][f"mean_{n}"]
        np.testing.assert_array_equal(a, b)
        for row in runs["jax"][f"mean_{n}"]:
            np.testing.assert_allclose(a, row, rtol=1e-6, atol=1e-7)
        true = (inp[f"g0_{n}"] + inp[f"e0_{n}"] + inp[f"g1_{n}"]
                + inp[f"e1_{n}"]) / 2
        np.testing.assert_allclose(a, true, rtol=0.02,
                                   atol=0.02 * np.abs(true).max())


def test_gpipe_on_four_ranks(runs):
    """Outputs against JAX's gpipe at 1e-6; the gradients of sum(out^2),
    each rank's own stage's and the microbatches' on every rank, against
    jax.grad through JAX's schedule at its own test's 1e-4 / 1e-5."""
    jax_out = runs["jax"]
    want = jax_out["gpipe"]
    for r in range(WORLD):
        got = runs["ranks"][r]
        np.testing.assert_allclose(got["gpipe"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["gpipe_dw"], jax_out["gpipe_dws"][r],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["gpipe_db"], jax_out["gpipe_dbs"][r],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["gpipe_dmb"], jax_out["gpipe_dmb"],
                                   rtol=1e-4, atol=1e-5)
    inp = _inputs(np.random.default_rng(0))
    ref = inp["mb"]
    for s in range(4):
        ref = np.tanh(ref @ inp["ws"][s] + inp["bs"][s])
    np.testing.assert_allclose(want, ref, rtol=1e-5, atol=1e-5)


def test_context_parallel_flash_on_two_ranks(runs):
    """On each 2-rank model axis of the 2 x 2 mesh: values against JAX's
    _context_parallel_flash and the whole-sequence flash at flash's float32
    forward tolerance; the gradients, summed over the axis by the port,
    against jax.vjp(_flash_ref) at the backward's."""
    jax_out = runs["jax"]
    for r in range(WORLD):
        got = runs["ranks"][r]
        np.testing.assert_allclose(got["cp_out"], jax_out["cp_out"],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["cp_out"], jax_out["flash_out"],
                                   rtol=2e-4, atol=2e-5)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[g], jax_out[g], rtol=2e-3,
                                       atol=2e-4)


def test_compressed_train_step_on_two_ranks(runs):
    """Reduced BitNet (float32, no quantization) through the port's
    compressed step on 2 ranks against the JAX compressed step on 2 pods,
    from the same state and batches: losses within rel 1e-5, gradient norms
    within 1e-4; parameters, moments and each rank's error-feedback state
    (its own residual, as each JAX pod keeps its own) within rtol 1e-4 but
    for 1 in 10^4 elements, and every element within the reach of one
    int8 step (a gradient at a rounding boundary may quantize to the next
    integer: lr x 2 in a parameter over 2 steps, two scales in ef)."""
    from repro_torch.train import Checkpointer
    from repro_torch.train.optimizer import tree_leaves

    jax_out = runs["jax"]
    for r in (0, 1):
        got = runs["ranks"][r]
        for i in range(STEPS):
            np.testing.assert_allclose(got[f"loss{i}"], jax_out[f"loss{i}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(got[f"grad_norm{i}"],
                                       jax_out[f"grad_norm{i}"], rtol=1e-4)
    work = runs["work"]
    _, want = Checkpointer(str(work / "jax_ckpt" / "final")).restore(
        device="cpu")
    _, port0 = Checkpointer(str(work / "port0")).restore(device="cpu")
    _, port1 = Checkpointer(str(work / "port1")).restore(device="cpu")
    # the ranks hold one parameter and optimizer state, each its own ef
    for a, b in zip(tree_leaves(port0[:2]), tree_leaves(port1[:2])):
        assert torch.equal(a, b)
    ef_pod1 = [torch.from_numpy(jax_out[f"ef_pod1_{i}"])
               for i in range(len(tree_leaves(want[2])))]
    pairs = [(a, b, 2 * LR * STEPS) for a, b in zip(
        tree_leaves(port0[0]), tree_leaves(want[0]))]
    pairs += [(a, b, None) for a, b in zip(tree_leaves(port0[2]),
                                           tree_leaves(want[2]))]
    pairs += [(a, b, None) for a, b in zip(tree_leaves(port1[2]), ef_pod1)]
    for a, b, reach in pairs:
        a, b = a.double(), b.double()
        off = ~torch.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert off.double().mean() <= 1e-4, float(off.double().mean())
        bound = reach if reach is not None else float(
            b.abs().max()) * 4 + 1e-6
        assert float((a - b).abs().max()) <= bound
    assert any(bool(e.abs().max() > 0) for e in tree_leaves(port0[2]))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(port0[2]), tree_leaves(port1[2])))


def test_redistribute_lays_dtensors_out_by_spec(runs):
    """A replicated 4 x 8 DTensor on the 2 x 2 (data, model) mesh:
    ("data", "model") leaves a 2 x 4 shard a rank, (None, "model") 4 x 4."""
    for r in range(WORLD):
        assert tuple(runs["ranks"][r]["local_dm"]) == (2, 4)
        assert tuple(runs["ranks"][r]["local_m"]) == (4, 4)


def test_grad_shardings_and_layer_params_lay_dtensors_out(runs):
    """build_train_step(grad_shardings=...) hands the optimizer the
    gradient of sum(w^2), w a replicated 4 x 8 DTensor, laid out by
    ("data", "model"): a 2 x 4 shard of 2 w a rank.  Under BitNet's
    train_4k rules on the 2 x 2 mesh, constrain_layer_params lays a
    DTensor attn/wq out by the parameter table, (None, "model"), and
    leaves a plain tensor as it is."""
    w = np.arange(32.0).reshape(4, 8)
    for r in range(WORLD):
        got = runs["ranks"][r]
        assert str(got["grad_placements"]) == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(got["grad_full"], 2 * w)
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(
            got["grad_local"], 2 * w[2 * i:2 * i + 2, 4 * j:4 * j + 4])
        assert str(got["wq_placements"]) == "(Replicate(), Shard(dim=1))"
        assert bool(got["k_norm_plain"])


# --------------------------------------------------------------------------- #
# one process: helpers, refusals, world size 1
# --------------------------------------------------------------------------- #

def test_dtensor_parameters_train_as_the_plain_run(runs):
    """A reduced BitNet (float32, no quantization) on DTensor parameters
    placed by place_params on the 2 x 2 (data, model) mesh, its batch on
    the data axis, the rules of a train shape active: the loss and every
    gradient equal the plain run's at the train tolerances (loss rtol
    1e-5; gradients rtol 1e-4, atol 1e-5 x max|g|: the shards sum their
    matmuls in another order)."""
    for r in runs["ranks"]:
        assert int(r["dt_placed"]) > 0          # some leaves are split
        np.testing.assert_allclose(r["dt_loss"], r["plain_loss"], rtol=1e-5)
        grads = sorted(k[len("dt_grad"):] for k in r if k.startswith(
            "dt_grad"))
        assert grads
        for i in grads:
            want = r[f"plain_grad{i}"]
            np.testing.assert_allclose(
                r[f"dt_grad{i}"], want, rtol=1e-4,
                atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def test_bubble_fraction():
    from repro.distributed.pipeline import bubble_fraction as jax_bubble
    from repro_torch.distributed import bubble_fraction

    for s, m in ((4, 6), (1, 8), (8, 56), (3, 1)):
        assert bubble_fraction(s, m) == jax_bubble(s, m)


def test_quantize_roundtrip_and_error_state():
    from repro_torch.distributed import collectives

    g = torch.from_numpy(np.random.default_rng(1).standard_normal(64)
                         .astype(np.float32))
    q, scale = collectives.quantize_int8(g)
    assert q.dtype == torch.int8
    err = (collectives.dequantize_int8(q, scale) - g).abs()
    assert float(err.max()) <= float(scale) * 0.51
    ef = collectives.init_error_state({"w": g, "b": {"x": q}})
    assert ef["w"].dtype == ef["b"]["x"].dtype == torch.float32
    assert float(ef["w"].abs().sum()) == 0


def test_process_group_refusals(tmp_path):
    from repro_torch.distributed import init_process_group

    with pytest.raises(ValueError, match="card"):
        init_process_group(str(tmp_path / "s"), 0, 1, device="meta")
    with pytest.raises(ValueError, match="absolute"):
        init_process_group("relative/store", 0, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_process_group(str(tmp_path / "s"), 0, 1)


def test_a_missing_rank_fails_within_the_timeout(tmp_path):
    """Rank 0 of a world of 2 whose rank 1 never comes: the group's
    timeout ends it with an error, not the test run's clock."""
    code = ("import sys; sys.path.insert(0, sys.argv[1] + '/src')\n"
            "from repro_torch.distributed import process_group\n"
            "with process_group(sys.argv[2], 0, 2, device='cpu', "
            "timeout_s=3):\n    print('joined')\n")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code, ROOT,
                           str(tmp_path / "store")], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "joined" not in proc.stdout
    assert time.monotonic() - t0 < 60


def test_world_of_one_runs_every_path(tmp_path):
    """A gloo group of one rank, as the card's NCCL group of one is: the
    compressed psum returns the member's own dequantized payload, gpipe
    with one stage equals the sequential run, and the model's flash path
    under make_rules(mesh(model=1), train_4k) goes through
    _context_parallel_flash and equals the plain flash path, values and
    gradients."""
    from repro_torch import configs
    from repro_torch.distributed import process_group
    from repro_torch.distributed.collectives import (
        compress_with_feedback, compressed_psum_pod,
    )
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention

    rng = np.random.default_rng(2)
    with process_group(str(tmp_path / "store"), 0, 1, device="cpu"):
        g = {"w": torch.from_numpy(rng.standard_normal((16, 8))
                                   .astype(np.float32))}
        e = {"w": torch.zeros(16, 8)}
        mean, new_e = compressed_psum_pod(g, e)
        q, s, ne = compress_with_feedback(g["w"], e["w"])
        assert torch.equal(mean["w"], q.float() * s)
        assert torch.equal(new_e["w"], ne)
        w = torch.from_numpy(rng.standard_normal((1, 8, 8))
                             .astype(np.float32))
        mb = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
        assert torch.equal(gpipe(lambda p, x: torch.tanh(x @ p), w[0], mb),
                           torch.tanh(mb @ w[0]))
        piped = [w[0].clone().requires_grad_(), mb.clone().requires_grad_()]
        plain = [w[0].clone().requires_grad_(), mb.clone().requires_grad_()]
        gpipe(lambda p, x: torch.tanh(x @ p), piped[0],
              piped[1]).square().sum().backward()
        torch.stack([torch.tanh(plain[1][i] @ plain[0]) for i in range(3)]
                    ).square().sum().backward()
        for a, b in zip(piped, plain):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)

        cfg = configs.get_config("bitnet-1.58b")
        rules = make_rules(cfg, make_host_mesh((1,), ("model",)),
                           configs.shape_by_name("train_4k"))
        assert rules.table["seq"] == "model"
        s_len, h, d = 4096, 1, 8
        base = [torch.from_numpy(rng.standard_normal((1, s_len, h, d))
                                 .astype(np.float32)) for _ in range(3)]
        dout = torch.from_numpy(rng.standard_normal((1, s_len, h, d))
                                .astype(np.float32))
        calls = []
        real = attention._context_parallel_flash

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

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
        assert len(calls) == 1
        for a, b in zip(*results):
            assert torch.equal(a, b)
