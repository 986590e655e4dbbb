"""Port parity: repro_torch.train (AdamW, the schedule, the train step) and
the straight-through fake-quantizers against repro.train and repro.quant,
on the same seeded inputs and the same starting state
(``train_state_from_jax``).

Tolerances:
- the STE gradients are the identity on both sides: equal bit for bit; the
  quantizers' forward values equal the expression without the estimator
  bit for bit, and JAX's within rtol 1e-6 (the weight scale is a mean
  summed in another order); ``bit_linear_train``'s gradients are
  float32 matmuls summed in another order: rtol 1e-5 / atol 1e-5;
- AdamW, ``global_norm`` and ``cosine_schedule`` on the same gradients:
  rtol 1e-6 (float32 elementwise maths; the norm's sum runs in another
  order), bfloat16 parameters within one bf16 rounding (2^-8);
- train steps of reduced BitNet: loss rel 1e-5, every gradient leaf rtol
  1e-4 / atol 1e-5 * max|g| (XLA and ATen sum the matmuls, norms and the
  softmax in other orders, ~1e-6 relative, which the backward and three
  AdamW steps carry on); parameters and moments after the steps alike.
The bitnet-quantized steps run under ``train_lockstep``: the int8
activation quantizer rounds at a boundary where a few float32 ulps of
difference flip a whole step, so the port takes the JAX package's
quantized values (after checking its own input against JAX's within 1e-5)
with its straight-through gradient, as the JAX quantizer has.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as jax_common
import repro_torch.configs as tconfigs
import repro_torch.models.common as port_common
from repro.configs import get_config, reduced
from repro.data import synthetic_batch
from repro.models import build_model as jax_build
from repro.quant import bitnet as jax_bitnet
from repro.train import AdamW as JaxAdamW
from repro.train import build_train_step as jax_train_step
from repro.train import cosine_schedule as jax_cosine
from repro.train import global_norm as jax_global_norm
from repro.train import init_train_state as jax_init_state
from repro_torch import train
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import build_model
from repro_torch.quant import bitnet as port_bitnet
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import value_and_grad

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# straight-through estimators
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name,shape", [("fake_quant_weight", (64, 32)),
                                        ("fake_quant_act", (8, 32))])
def test_ste_gradient_is_the_identity_as_in_jax(name, shape):
    rng = np.random.default_rng(0)
    x, r = _rand(shape, rng), _rand(shape, rng)
    jfn, pfn = getattr(jax_bitnet, name), getattr(port_bitnet, name)
    jout, jgrad = jax.value_and_grad(
        lambda a: jnp.sum(jfn(a) * r))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    out = pfn(t)
    (out * torch.from_numpy(r)).sum().backward()
    # forward values unchanged bit for bit: the expression without the
    # estimator, on the port's own quantizer
    xt = torch.from_numpy(x)
    if name == "fake_quant_weight":
        q, gamma = port_bitnet.quantize_weight_ternary(xt)
        plain = xt + (q.to(xt.dtype) * gamma - xt)
    else:
        sc = port_bitnet.act_scale(xt)
        plain = xt + (torch.clamp(torch.round(xt / sc), -128, 127) * sc - xt)
    assert torch.equal(out.detach(), plain)
    # against JAX: gamma = mean(|w|) is summed in another order (one ulp)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jfn(jnp.asarray(x))), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(np.asarray(jgrad), r)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jgrad))


def test_bit_linear_train_gradients_against_jax():
    rng = np.random.default_rng(1)
    x, w, r = _rand((8, 64), rng), _rand((64, 32), rng), _rand((8, 32), rng)
    jval = jax_bitnet.bit_linear_train(jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(
        jax_bitnet.bit_linear_train(a, b) * r), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = port_bitnet.bit_linear_train(tx, tw)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jval), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #

def test_adamw_schedule_and_norm_against_jax():
    rng = np.random.default_rng(2)
    params = {"w": _rand((16, 8), rng), "b": _rand((8,), rng),
              "emb": {"t": _rand((4, 8), rng)},
              "h": _rand((8, 8), rng)}
    # the third step's gradients are large: the clip by global norm acts
    grads = [{"w": _rand((16, 8), rng) * s, "b": _rand((8,), rng) * s,
              "emb": {"t": _rand((4, 8), rng) * s},
              "h": _rand((8, 8), rng) * s}
             for s in (0.01, 0.1, 10.0)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    jopt = JaxAdamW(lr=jax_cosine(1e-2, warmup=2, total=10), **kw)
    topt = train.AdamW(lr=train.cosine_schedule(1e-2, warmup=2, total=10),
                       **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jp["h"] = jp["h"].astype(jnp.bfloat16)
    tp = jax.tree.map(torch.from_numpy, params)
    tp["h"] = tp["h"].to(torch.bfloat16)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.mu["h"].dtype == torch.float32 and ts.step.dtype == torch.int32
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        tg = jax.tree.map(torch.from_numpy, g)
        jp, js, jn = jopt.update(jg, js, jp)
        tp, ts, tn = topt.update(tg, ts, tp)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert int(ts.step) == int(js.step)
        for a, b in zip(tree_leaves((ts.mu, ts.nu)),
                        jax.tree.leaves((js.mu, js.nu))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)
        for k in ("w", "b", "emb"):
            np.testing.assert_allclose(
                np.asarray(jax.tree.leaves(tp[k])[0].numpy()),
                np.asarray(jax.tree.leaves(jp[k])[0]), rtol=1e-6, atol=1e-7)
        assert tp["h"].dtype == torch.bfloat16
        np.testing.assert_allclose(tp["h"].float().numpy(),
                                   np.asarray(jp["h"], np.float32),
                                   rtol=2 ** -8)
    jlr, tlr = jax_cosine(0.5, 3, 12), train.cosine_schedule(0.5, 3, 12)
    for s in range(15):
        assert float(tlr(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(jlr(jnp.asarray(s, jnp.int32))), rel=1e-6,
                          abs=1e-9)
    assert float(train.global_norm(jax.tree.map(torch.from_numpy,
                                                grads[1]))) == pytest.approx(
        float(jax_global_norm(jax.tree.map(jnp.asarray, grads[1]))),
        rel=1e-6)


# --------------------------------------------------------------------------- #
# the train step on reduced BitNet
# --------------------------------------------------------------------------- #

def _configs(**kw):
    jcfg = reduced(get_config("bitnet-1.58b")).replace(dtype="float32", **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32", **kw)
    return jcfg, tcfg


def _start(jcfg, tcfg):
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jopt, topt = JaxAdamW(lr=1e-3), train.AdamW(lr=1e-3)
    jst = jax_init_state(japi, jopt, jax.random.PRNGKey(0))
    tst = train_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    return japi, tapi, jopt, topt, jst, tst


def _batch(cfg, b, s, step):
    np_batch = synthetic_batch(cfg, batch=b, seq=s, step=step)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _close_trees(port_tree, jax_tree, rtol=1e-4, rel_atol=1e-5):
    """Every leaf within rtol / atol = rel_atol * max|leaf| (JAX side)."""
    got, want = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=rtol,
                                   atol=rel_atol * float(np.abs(b).max()))


def _close_params(port_state, jax_state, lr):
    """Parameters after AdamW steps: all but 1 in 10^4 elements of a leaf
    within rtol 1e-4 / atol 1e-5 * max|p|, and every element within one
    step's move (lr) per step.  Where sqrt(nu) is near eps (1e-8) the step
    lr * mu / (sqrt(nu) + eps) is ill-conditioned: a gradient that differs
    by 1e-9 moves it by up to lr (observed: one element of 65,536 at 7.1e-6
    after one step, its first gradient ~1e-8), and the parameter keeps that
    difference through later steps.  The moments, linear in the
    gradients, are held at the tight tolerance everywhere."""
    steps = int(jax_state.opt.step)
    for a, b in zip(tree_leaves(port_state.params),
                    jax.tree.leaves(jax_state.params)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=lr * steps)
        loose = ~np.isclose(a, b, rtol=1e-4,
                            atol=1e-5 * float(np.abs(b).max()))
        assert loose.sum() <= max(1, b.size // 10 ** 4), (
            f"{loose.sum()} of {b.size} outside rtol 1e-4")


@pytest.fixture
def count_cpu_backward(monkeypatch):
    """Calls of the flash Function's CPU backward (the plain version)."""
    calls = []
    real = fa.attention_bwd_ref

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "attention_bwd_ref", counted)
    return calls


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_on_the_flash_path_against_jax(steps,
                                                   count_cpu_backward):
    """float32 without quantization at S = 3072 (> FLASH_THRESHOLD): JAX
    trains through ``_flash_ref``'s custom VJP, the port through its flash
    Function (the plain versions on the CPU)."""
    jcfg, tcfg = _configs(quantization="none")
    japi, tapi, jopt, topt, jst, tst = _start(jcfg, tcfg)
    jb, tb = _batch(jcfg, 1, 3072, 0)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jst.params, jb)
    tl, tg = value_and_grad(tapi.loss, tst.params, tb)
    assert len(count_cpu_backward) == tcfg.layers
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _close_trees(tg, jg)

    jstep = jax.jit(jax_train_step(japi, jopt))
    tstep = train.build_train_step(tapi, topt)
    for i in range(steps):
        jb, tb = _batch(jcfg, 1, 3072, i)
        jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    assert len(count_cpu_backward) == tcfg.layers * (steps + 1)
    _close_params(tst, jst, 1e-3)
    _close_trees((tst.opt.mu, tst.opt.nu), (jst.opt.mu, jst.opt.nu))


@contextlib.contextmanager
def train_lockstep(monkeypatch):
    """Run a (jitted) JAX call that records every activation quantizer's
    input and output, then the port's call, whose quantizer checks its
    input against the recorded one and returns the recorded output with
    the straight-through gradient: ``x + (want_out - x).detach()``.  (The
    forward ``lockstep`` of test_torch_models.py returns a tensor cut from
    the graph.)"""
    tape = []

    def jax_fq(x):
        out = jax_bitnet.fake_quant_act(x)
        jax.debug.callback(lambda a, b: tape.append(
            (np.asarray(a), np.asarray(b))), x, out, ordered=True)
        return out

    def port_fq(x):
        want_in, want_out = tape.pop(0)
        np.testing.assert_allclose(x.detach().numpy(), want_in, **TOL)
        return x + (torch.from_numpy(want_out.copy()) - x).detach()

    def run(jax_fn, port_fn):
        with monkeypatch.context() as mp:
            mp.setattr(jax_common, "fake_quant_act", jax_fq)
            j = jax.block_until_ready(jax_fn())
            jax.effects_barrier()
        assert tape
        with monkeypatch.context() as mp:
            mp.setattr(port_common, "fake_quant_act", port_fq)
            t = port_fn()
        assert not tape, f"{len(tape)} quantizer calls left over"
        return j, t

    yield run


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_with_bitnet_quantization_against_jax(steps,
                                                          monkeypatch):
    jcfg, tcfg = _configs()
    assert jcfg.quantization == tcfg.quantization == "bitnet"
    japi, tapi, jopt, topt, jst, tst = _start(jcfg, tcfg)
    tstep = train.build_train_step(tapi, topt)
    with train_lockstep(monkeypatch) as run:
        jb, tb = _batch(jcfg, 2, 64, 0)
        (jl, jg), (tl, tg) = run(
            lambda: jax.jit(jax.value_and_grad(japi.loss))(jst.params, jb),
            lambda: value_and_grad(tapi.loss, tst.params, tb))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        _close_trees(tg, jg)
        for i in range(steps):
            jb, tb = _batch(jcfg, 2, 64, i)
            # a fresh jit per step: the recording quantizer runs at trace
            (jst, jm), (tst, tm) = run(
                lambda: jax.jit(jax_train_step(japi, jopt))(jst, jb),
                lambda: tstep(tst, tb))
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-5)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-4)
    _close_params(tst, jst, 1e-3)
    _close_trees((tst.opt.mu, tst.opt.nu), (jst.opt.mu, jst.opt.nu))


@pytest.mark.parametrize("size", [
    {}, dict(quantization="none", d_model=1024, d_ff=2752, n_heads=8,
             kv_heads=8, head_dim=128)], ids=["reduced", "width_1024"])
def test_lr_1e3_on_a_repeated_sequence_tracks_jax(size, monkeypatch, capsys):
    """The full-width card run's recipe at cut sizes: AdamW at lr 1e-3 on
    one sequence repeated for 6 steps, with bitnet quantization at the
    reduced size and without it at BitNet-1.58B's d_ff / d_model and head
    width with d_model 1024 (where the loss rises at the third step; a
    ternary weight of a wide layer can round otherwise when JAX's mean |w|
    differs by an ulp, which ``train_lockstep`` does not hand over).  Each step's loss equals JAX's within rel 1e-5, so a
    rise or fall of the loss is the recipe's on both sides; the two
    trajectories are printed (``pytest -s``)."""
    jcfg, tcfg = _configs(**size)
    japi, tapi, jopt, topt, jst, tst = _start(jcfg, tcfg)
    tstep = train.build_train_step(tapi, topt)
    jb, tb = _batch(jcfg, 2, 64, 0)
    losses = {"jax": [], "port": []}
    if tcfg.quantization == "bitnet":
        lockstep = train_lockstep(monkeypatch)
        jstep = lambda st: jax.jit(jax_train_step(japi, jopt))(st, jb)  # noqa: E731
    else:
        lockstep = contextlib.nullcontext(lambda j, t: (j(), t()))
        jstep = lambda st, f=jax.jit(jax_train_step(japi, jopt)): f(st, jb)  # noqa: E731
    with lockstep as run:
        for _ in range(6):
            (jst, jm), (tst, tm) = run(lambda: jstep(jst),
                                       lambda: tstep(tst, tb))
            losses["jax"].append(float(jm["loss"]))
            losses["port"].append(float(tm["loss"]))
            assert losses["port"][-1] == pytest.approx(losses["jax"][-1],
                                                       rel=1e-5)
    with capsys.disabled():
        print(f"\n{tcfg.layers} x {tcfg.d_model}, {tcfg.quantization}, "
              f"lr 1e-3, one sequence x 6 steps: {losses}")


def test_compressed_step_at_lr_3e5_tracks_jax(tmp_path, capsys):
    """The full-width card run's compressed recipe (one rank, lr 3e-5, one
    sequence repeated for 6 steps) at BitNet-1.58B's d_ff / d_model and
    head width with d_model 1024, without quantization: JAX's compressed
    step on a one-device pod mesh and the port's in a one-rank gloo group.
    Each step's loss equals JAX's within rel 1e-5, so a rise of the loss
    (the card run's 10.823, 7.971, 9.853, 7.475) is the recipe's on both
    sides; the two trajectories are printed (``pytest -s``)."""
    from repro.compat import make_mesh
    from repro.train.train_loop import (
        build_compressed_train_step as jax_compressed_step)
    from repro_torch.distributed import process_group
    from repro_torch.train.train_loop import build_compressed_train_step

    jcfg, tcfg = _configs(quantization="none", d_model=1024, d_ff=2752,
                          n_heads=8, kv_heads=8, head_dim=128)
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jopt, topt = JaxAdamW(lr=3e-5), train.AdamW(lr=3e-5)
    jst = jax_init_state(japi, jopt, jax.random.PRNGKey(0), compressed=True)
    tst = train_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    jstep = jax.jit(jax_compressed_step(japi, jopt,
                                        make_mesh((1,), ("pod",))))
    jb, tb = _batch(jcfg, 2, 64, 0)
    losses = {"jax": [], "port": []}
    with process_group(str(tmp_path / "store"), 0, 1, device="cpu"):
        tstep = build_compressed_train_step(tapi, topt)
        for _ in range(6):
            jst, jm = jstep(jst, jb)
            tst, tm = tstep(tst, tb)
            losses["jax"].append(float(jm["loss"]))
            losses["port"].append(float(tm["loss"]))
            assert losses["port"][-1] == pytest.approx(losses["jax"][-1],
                                                       rel=1e-5)
    with capsys.disabled():
        print(f"\n{tcfg.layers} x {tcfg.d_model}, compressed, lr 3e-5, one "
              f"sequence x 6 steps: {losses}")


def test_grad_accum_equivalence():
    """As tests/test_train.py::test_grad_accum_equivalence: two
    microbatches of 2 against one batch of 4."""
    _, tcfg = _configs()
    api = build_model(tcfg, device="cpu")
    opt = train.AdamW(lr=1e-3, weight_decay=0.0)
    state = train.init_train_state(api, opt, 0)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        tcfg, batch=4, seq=64, step=0).items()}
    _, m1 = train.build_train_step(api, opt, grad_accum=1)(state, batch)
    _, m2 = train.build_train_step(api, opt, grad_accum=2)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-3)


def test_remat_changes_no_gradient(monkeypatch):
    """``remat="block"`` checkpoints each block (one call per layer) and
    recomputes it in the backward: the gradients equal those without."""
    _, tcfg = _configs()
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        tcfg, batch=2, seq=64, step=0).items()}
    params = build_model(tcfg, device="cpu").init(0)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    grads = {}
    for remat in ("none", "block"):
        api = build_model(tcfg.replace(remat=remat), device="cpu")
        grads[remat] = value_and_grad(api.loss, params, batch)
    assert calls == [False] * tcfg.layers
    assert torch.equal(grads["none"][0], grads["block"][0])
    for a, b in zip(tree_leaves(grads["none"][1]),
                    tree_leaves(grads["block"][1])):
        assert torch.equal(a, b)


def _deep(arch, layers, **kw):
    return tconfigs.reduced(tconfigs.get_config(arch)).replace(
        dtype="float32", layers=layers, **kw)


@pytest.mark.parametrize("arch", ["bitnet-1.58b", "mamba2-130m"])
def test_remat_schedules_change_no_gradient(monkeypatch, arch):
    """At 8 layers (best_grouping 2): per-layer remat alone (flat), JAX's
    two-level schedule (``"block"``) and the ``"dots"`` policy give the
    loss and gradients of the step without remat, bit for bit: the
    recomputations run the same operations."""
    tcfg = _deep(arch, 8)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        tcfg, batch=2, seq=64, step=0).items()}
    params = build_model(tcfg, device="cpu").init(0)

    def grads(remat, groups=port_common.remat_groups):
        with monkeypatch.context() as m:
            m.setattr(port_common, "remat_groups", groups)
            api = build_model(tcfg.replace(remat=remat), device="cpu")
            return value_and_grad(api.loss, params, batch)

    want = grads("none")
    for got in (grads("block", lambda cfg, n: 1), grads("block"),
                grads("dots")):
        assert torch.equal(got[0], want[0])
        for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("arch", ["bitnet-1.58b", "mamba2-130m"])
def test_remat_groups_as_jax_scan(monkeypatch, arch, remat):
    """The train forward at 8 layers is G = best_grouping(8) = 2 outer
    non-reentrant checkpoints of 4 layers each, each layer under its own
    inside (``"dots"`` passing its selective context to both); a step
    runs each layer's forward 3 times (``remat_forwards``)."""
    tcfg = _deep(arch, 8, remat=remat)
    assert port_common.remat_groups(tcfg, 8) == 2
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        tcfg, batch=1, seq=32, step=0).items()}
    api = build_model(tcfg, device="cpu")
    params = api.init(0)
    real = torch.utils.checkpoint.checkpoint
    depth, calls, layers = [0], [], []

    def spied(fn, *a, **kw):
        calls.append((depth[0], kw.get("use_reentrant"),
                      "context_fn" in kw))
        depth[0] += 1
        try:
            return real(fn, *a, **kw)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spied)
    api.loss(params, batch)
    dots = remat == "dots"
    assert calls == ([(0, False, dots)] + [(1, False, dots)] * 4) * 2
    from repro_torch.models import mamba2, transformer

    module, name = ((transformer, "_train_block") if arch.startswith(
        "bitnet") else (mamba2, "ssm_block"))
    block = getattr(module, name)

    def counted(*a, **kw):
        layers.append(1)
        return block(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    value_and_grad(api.loss, params, batch)
    assert len(layers) == port_common.remat_forwards(tcfg, 8) == 3 * 8


def test_two_level_remat_lowers_the_peak(monkeypatch):
    """The cost counter's peak of a reduced 16-layer Mamba-2 step
    (best_grouping 4; 4,096 tokens and a 256-token vocabulary, so that the
    layer inputs ("carries") set the peak, not the parameters' gradients):
    per-layer remat keeps the 16 layer inputs into the backward, the
    two-level schedule the 4 group inputs and, in the group being
    differentiated, its other 3 layers' inputs (its first layer's is the
    group's): the peak falls by exactly L - G - L/G + 1 = 9 carries."""
    from repro_torch.launch.hlo_cost import CostCounter

    tcfg = _deep("mamba2-130m", 16, remat="block", vocab=256)
    groups = port_common.remat_groups(tcfg, 16)
    b, s = 4, 1024
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        tcfg, batch=b, seq=s, step=0).items()}
    api = build_model(tcfg, device="cpu")
    params = api.init(0)

    def peak(groups_fn):
        with monkeypatch.context() as m:
            m.setattr(port_common, "remat_groups", groups_fn)
            counter = CostCounter()
            counter.track_external(tree_leaves(params))
            base = counter.live_bytes
            with counter:
                value_and_grad(api.loss, params, batch)
        return counter.peak_bytes - base

    carry = b * s * tcfg.d_model * 4
    drop = peak(lambda cfg, n: 1) - peak(port_common.remat_groups)
    assert groups == 4
    assert drop == (16 - groups - 16 // groups + 1) * carry


@pytest.mark.parametrize("layers", [1, 2, 12, 32, 36, 81])
def test_best_grouping_as_jax(layers):
    from repro.models.common import best_grouping as jax_grouping
    from repro_torch.models.common import best_grouping

    assert best_grouping(layers) == jax_grouping(layers)


# --------------------------------------------------------------------------- #
# the SSM families' embedding gradient
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_embedding_gradient_is_bit_equal_across_runs(arch):
    """Mamba-2 and Zamba2 gather their token embeddings with F.embedding,
    whose backward sums each row's gradient in a fixed order (indexing's
    accumulates with atomics on the CPU): two backward passes of the
    reduced model's next-token loss over 3072 tokens give bit-equal
    embedding gradients, and its logits match the JAX package's (float32,
    no quantization, 1e-4 as test_torch_hybrid.py's whole-model runs)."""
    jcfg = reduced(get_config(arch)).replace(dtype="float32",
                                             quantization="none")
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(
        dtype="float32", quantization="none")
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(11).integers(
        1, tcfg.vocab, size=(1, 3072)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    targets = batch["tokens"][:, 1:].reshape(-1).long()

    def embed_grad():
        table = tp["embed"]["tokens"].detach().clone().requires_grad_()
        logits = tapi.train_logits(dict(tp, embed={"tokens": table}), batch)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]), targets)
        return torch.autograd.grad(loss, table)[0], logits.detach()

    (first, logits), (second, _) = embed_grad(), embed_grad()
    assert first.abs().sum() > 0
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    want = japi.train_logits(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
