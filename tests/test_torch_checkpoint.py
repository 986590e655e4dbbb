"""Port parity: repro_torch.train.checkpoint and fault_tolerance against
repro.train's.

The two packages write the same layout (``step_XXXXXXXX/{arrays.npz,
manifest.json, structure.json}``, an atomic ``LATEST``), so each restores
what the other wrote, bfloat16 included (raw bytes with ``"dtype":
"bfloat16"``): checked equal bit for bit, as is a crash at ``fail_at``
resumed from the last checkpoint against an uninterrupted run (the CPU
runs the same operations in the same order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro.train import AdamW as JaxAdamW
from repro.train import Checkpointer as JaxCheckpointer
from repro.train import init_train_state as jax_init_state
from repro_torch.convert import train_state_from_jax
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.train import (
    AdamW,
    Checkpointer,
    TrainingRunner,
    build_train_step,
    init_train_state,
)
from repro_torch.train.optimizer import AdamWState, tree_leaves
from repro_torch.train.train_loop import TrainState


def _bits(t):
    """A leaf's bytes as integers, so bf16 compares bit for bit."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(port_tree, other_leaves):
    got = tree_leaves(port_tree)
    assert len(got) == len(other_leaves)
    for a, b in zip(got, other_leaves):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


def test_roundtrip_bf16_and_namedtuples(tmp_path):
    state = TrainState(
        params={"w": torch.ones((4, 4), dtype=torch.bfloat16) / 3},
        opt=AdamWState(step=torch.tensor(7, dtype=torch.int32),
                       mu={"w": torch.full((4, 4), 0.5)},
                       nu={"w": torch.full((4, 4), 0.25)}),
        ef=None,
    )
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state, blocking=True)
    step, restored = ck.restore(example=state, device="cpu")
    assert step == 7
    assert isinstance(restored, TrainState) and restored.ef is None
    assert isinstance(restored.opt, AdamWState)
    assert restored.params["w"].dtype == torch.bfloat16
    assert restored.opt.step.dtype == torch.int32
    _assert_same(restored, tree_leaves(state))
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert manifest["exotic"] == {"/0/w": {"dtype": "bfloat16",
                                           "shape": [4, 4]}}
    # without an example: the stored structure, tuples for NamedTuples
    _, plain = ck.restore(device="cpu")
    assert type(plain) is tuple and plain[2] is None
    _assert_same(plain, tree_leaves(state))


def test_compressed_state_with_ef_converts_and_roundtrips(tmp_path):
    """A compressed TrainState of the JAX package (error-feedback state
    ``ef``, float32 like the params, non-zero) converts with its ``ef``,
    and round-trips through the port's Checkpointer bit for bit; the JAX
    package restores the port's files, whose manifest and structure are
    the ones it writes itself."""
    cfg = reduced(get_config("bitnet-1.58b"))
    opt = JaxAdamW(lr=1e-3)
    jst = jax_init_state(jax_build(cfg), opt, jax.random.PRNGKey(4),
                         compressed=True)
    rng = np.random.default_rng(4)
    jst = jst._replace(ef=jax.tree.map(
        lambda e: jnp.asarray(rng.standard_normal(e.shape), jnp.float32)
        * 1e-3, jst.ef))
    state = train_state_from_jax(jax.tree.map(np.asarray, jst),
                                 device="cpu")
    assert state.ef is not None
    assert state.ef["embed"]["tokens"].dtype == torch.float32
    _assert_same(state, jax.tree.leaves(jst))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(3, state, blocking=True)
    _, back = ck.restore(example=state, device="cpu")
    assert isinstance(back, TrainState) and back.ef is not None
    _assert_same(back, tree_leaves(state))
    JaxCheckpointer(str(tmp_path / "jax")).save(3, jst, blocking=True)
    _, from_port = JaxCheckpointer(str(tmp_path / "port")).restore(
        example=jst)
    _assert_same(state, jax.tree.leaves(from_port))
    for name in ("manifest.json", "structure.json"):
        assert json.loads((tmp_path / "port" / "step_00000003" /
                           name).read_text()) == json.loads(
            (tmp_path / "jax" / "step_00000003" / name).read_text())


def test_latest_pointer_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.tensor([s])}, blocking=True)
    assert ck.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert (tmp_path / "LATEST").read_text() == "step_00000004"
    _, t = ck.restore(device="cpu")
    assert int(t["x"][0]) == 4
    _, t = ck.restore(3, device="cpu")
    assert int(t["x"][0]) == 3
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device="cpu")


def _jax_state():
    """A reduced BitNet TrainState in bf16, written by the JAX package, with
    non-zero moments and step (one hand-made update)."""
    cfg = reduced(get_config("bitnet-1.58b"))
    assert cfg.dtype == "bfloat16"
    opt = JaxAdamW(lr=1e-3)
    state = jax_init_state(jax_build(cfg), opt, jax.random.PRNGKey(3))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype),
                         state.params)
    params, opt_state, _ = opt.update(grads, state.opt, state.params)
    return state._replace(params=params, opt=opt_state)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jst = _jax_state()
    JaxCheckpointer(str(tmp_path)).save(5, jst, blocking=True)
    want = train_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    step, got = Checkpointer(str(tmp_path)).restore(example=want,
                                                    device="cpu")
    assert step == 5 and isinstance(got, TrainState)
    assert got.params["embed"]["tokens"].dtype == torch.bfloat16
    _assert_same(got, tree_leaves(want))
    _assert_same(got, jax.tree.leaves(jst))


def test_port_checkpoint_restores_in_jax(tmp_path):
    jst = _jax_state()
    port_state = train_state_from_jax(jax.tree.map(np.asarray, jst),
                                      device="cpu")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    Checkpointer(str(tmp_path / "port")).save(5, port_state, blocking=True)
    JaxCheckpointer(str(tmp_path / "jax")).save(5, jst, blocking=True)
    step, restored = JaxCheckpointer(str(tmp_path / "port")).restore(
        example=jst)
    assert step == 5
    assert restored.params["embed"]["tokens"].dtype == jnp.bfloat16
    _assert_same(port_state, jax.tree.leaves(restored))
    # the same files: manifest and structure as the JAX package writes them
    for name in ("manifest.json", "structure.json"):
        assert json.loads((tmp_path / "port" / "step_00000005" /
                           name).read_text()) == json.loads(
            (tmp_path / "jax" / "step_00000005" / name).read_text())


def test_crash_restart_resumes_bit_for_bit(tmp_path):
    """As tests/test_checkpoint.py::test_crash_restart_resumes_
    deterministically: a crash at step 7 resumes from the checkpoint at 6
    and ends where an uninterrupted run does."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen3-1.7b"))
    api = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    stepfn = build_train_step(api, opt)

    def batch_fn(s):
        return {k: torch.from_numpy(v) for k, v in synthetic_batch(
            cfg, batch=2, seq=32, step=s).items()}

    runner = TrainingRunner(stepfn, batch_fn, init_train_state(api, opt, 0),
                            Checkpointer(str(tmp_path)), ckpt_every=3,
                            device="cpu")
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        runner.run(10, fail_at=7, install_signal_handler=False)
    assert Checkpointer(str(tmp_path)).latest_step() == 6

    runner2 = TrainingRunner(stepfn, batch_fn,
                             init_train_state(api, opt, 99),
                             Checkpointer(str(tmp_path)), ckpt_every=3,
                             device="cpu")
    m = runner2.run(10, install_signal_handler=False)
    assert runner2.start_step == 6
    assert Checkpointer(str(tmp_path)).latest_step() == 10

    state3 = init_train_state(api, opt, 0)
    for s in range(10):
        state3, m3 = stepfn(state3, batch_fn(s))
    assert torch.equal(m["loss"], m3["loss"])
    _assert_same(runner2.state, tree_leaves(state3))


def test_run_restores_the_sigterm_handler(tmp_path):
    """run() installs its preemption handler for the run's length only:
    the handler it replaced is back after a run, also one that raised, so
    the signal module keeps no runner (nor its state) alive."""
    import signal

    cfg = tconfigs.reduced(tconfigs.get_config("qwen3-1.7b"))
    api = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3, weight_decay=0.0)

    def batch_fn(s):
        return {k: torch.from_numpy(v) for k, v in synthetic_batch(
            cfg, batch=2, seq=16, step=s).items()}

    def sentinel(signum, frame):
        pass

    before = signal.signal(signal.SIGTERM, sentinel)
    try:
        runner = TrainingRunner(build_train_step(api, opt), batch_fn,
                                init_train_state(api, opt, 0),
                                Checkpointer(str(tmp_path)), device="cpu")
        runner.run(1)
        assert signal.getsignal(signal.SIGTERM) is sentinel
        with pytest.raises(RuntimeError, match="injected failure"):
            runner.run(3, fail_at=1)
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, before)
