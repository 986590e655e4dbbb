"""Port parity: repro_torch's ShardedExecutor against the in-process
executor and against the JAX package's ShardedExecutor.

Shards run on CPU devices here (``devices=["cpu"] * 4``), each shard's
product through the plain version of the grouped bitlinear kernel; on the
card, ``chip_smoke.py``'s ``sharded`` phase runs the kernel.  Outputs must
be bit-exact and the instrument stream (traffic, cycles) equal.  The JAX
executor runs in a subprocess with 4 forced host devices, as
``tests/test_pipeline.py`` does, so this process keeps one JAX device.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import dlegion
from repro_torch.core.scheduler import plan_stage
from repro_torch.core.sparsity import ztb_from_weight
from repro_torch.core.workloads import (
    ATTN_SCORE, HEAD_PER_UNIT, N_PARTITION, QKV_PROJ, GEMMWorkload,
)
from repro_torch.legion import (
    InProcessExecutor, Machine, ShardedExecutor, prepare_context,
    synthesize_operands,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = dlegion()                 # 8 Legions x 8 cores x 16x16
CPU4 = ["cpu"] * 4


def _w2(bits=2):
    return GEMMWorkload(stage=QKV_PROJ, m=32, k=256, n=128, weight_bits=bits,
                        count=8, shared_input=True, mapping=HEAD_PER_UNIT)


def _w8():
    return GEMMWorkload(stage=ATTN_SCORE, m=32, k=128, n=128, weight_bits=8,
                        count=4, kv_group=2, mapping=N_PARTITION)


def _sharded(cfg=CFG, devices=CPU4, **kw):
    ex = ShardedExecutor(devices=devices)
    return Machine(cfg, backend=ex, device="cpu", **kw), ex


def _same_run(a, b):
    assert np.array_equal(a.outputs, b.outputs)
    assert a.outputs.dtype == b.outputs.dtype == np.int32
    assert a.trace.totals == b.trace.totals
    assert a.cycles.total_cycles == b.cycles.total_cycles


MODE_MATRIX = [(bits, ztb) for bits in (2, 4, 8) for ztb in (False, True)]


@pytest.mark.parametrize("bits,ztb", MODE_MATRIX)
def test_sharded_bit_exact_against_in_process_mode_matrix(bits, ztb):
    """JAX's mode matrix: W1.58 / W4 / W8 +-ZTB, a shared x over 8
    Legions on 4 CPU shards."""
    w = _w2(bits)
    sparsity = 0.5 if ztb else 0.0
    inproc = Machine(CFG, device="cpu").run(w, ztb_sparsity=sparsity)
    machine, ex = _sharded()
    sharded = machine.run(w, ztb_sparsity=sparsity)
    _same_run(inproc, sharded)
    assert sharded.backend == "sharded" and sharded.ok
    assert ex.devices_used == 4


@pytest.mark.parametrize("ndev", [1, 3, 4, 8, 16])
def test_per_instance_x_and_uneven_shards(ndev):
    """Per-instance x (N-partitioned attention scores) on 1 to 16 CPU
    devices: padded Legion slots (8 Legions over 3 shards), more devices
    than Legions (nshard = min), one device."""
    w = _w8()
    plan = plan_stage(CFG, w)
    x, weights = synthesize_operands(w, seed=9)
    assert x.ndim == 3
    inproc = Machine(CFG, device="cpu").run(plan, x, weights)
    machine, ex = _sharded(devices=["cpu"] * ndev)
    _same_run(inproc, machine.run(plan, x, weights))
    legions = len({a.legion for a in plan.assignments})
    assert ex.devices_used == min(ndev, legions)


def test_shards_of_padding_only_launch_nothing():
    """5 Legions on 4 devices: 2 a shard, so the last shard holds padding
    only; its product is skipped and the outputs stay exact."""
    cfg = dlegion(legions=5)
    w = dataclasses.replace(_w2(), count=5)
    inproc = Machine(cfg, device="cpu").run(w)
    machine, ex = _sharded(cfg)
    _same_run(inproc, machine.run(w))
    assert ex.devices_used == 4


def test_caller_books_gate_non_zero_windows():
    """A caller book that gates windows holding non-zero data: the sharded
    path must drop their contributions exactly as the in-process skip."""
    w = _w8()
    plan = plan_stage(CFG, w)
    x, weights = synthesize_operands(w, seed=9)
    masked = weights.copy().astype(np.int8)
    masked[0, : plan.assignments[0].k_window, :] = 0
    books = [ztb_from_weight(np.asarray(m), block_k=CFG.d, block_n=CFG.d,
                             window=CFG.cores) for m in masked]
    in_g = Machine(CFG, device="cpu").run(plan, x, weights, ztb=books)
    machine, _ = _sharded()
    sh_g = machine.run(plan, x, weights, ztb=books)
    _same_run(in_g, sh_g)
    plain = Machine(CFG, device="cpu").run(plan, x, weights)
    assert not np.array_equal(sh_g.outputs, plain.outputs)
    # the shard's copy is zeroed, never the session's operands
    again = machine.run(plan, x, weights)
    assert np.array_equal(again.outputs, plain.outputs)


def test_refusals():
    w = _w8()
    plan = plan_stage(CFG, w)
    x, weights = synthesize_operands(w)
    machine, _ = _sharded()
    with pytest.raises(ValueError, match="bit-exact"):
        machine.run(plan, x.astype(np.float32), weights.astype(np.float32),
                    check_outputs=False)
    with pytest.raises(ValueError, match="granularity"):
        _sharded(granularity="kernel")[0].run(w)
    with pytest.raises(ValueError, match="per-core"):
        _sharded(emulate_cores=True)[0].run(_w2(), ztb_sparsity=0.5)
    _sharded(emulate_cores=True)[0].run(_w2())
    # the fourth refusal: a shard's device must take the session's kernel
    # backend (a CUDA session's kernel is never traded for the plain
    # version on a CPU shard)
    ctx = prepare_context(CFG, plan, x, weights, device="cpu")
    with pytest.raises(ValueError, match="kernel_backend"):
        ShardedExecutor(devices=CPU4).execute(
            dataclasses.replace(ctx, kernel_backend="cuda"), [])
    with pytest.raises(ValueError, match="at least one"):
        ShardedExecutor(devices=[])


def test_devices_none_is_every_card():
    if torch.cuda.is_available():
        assert len(ShardedExecutor().devices) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedExecutor()


def test_serve_backend_takes_the_executor():
    """LegionServeBackend(..., executor=ShardedExecutor(...)): a decode and
    a prefill step tally and compute exactly as the in-process backend."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import LegionServeBackend

    cfg = reduced(get_config("bitnet-1.58b"))
    params = build_model(cfg, device="cpu").init(0)
    inproc = LegionServeBackend(dlegion(8), cfg, params, device="cpu")
    ex = ShardedExecutor(devices=["cpu"] * 2)
    sharded = LegionServeBackend(dlegion(8), cfg, params, device="cpu",
                                 executor=ex)
    assert sharded.machine.backend.name == "sharded"
    for m, contexts in ((1, (16,)), (8, (8,))):
        assert dataclasses.asdict(inproc.step_tally(m, contexts)) == \
            dataclasses.asdict(sharded.step_tally(m, contexts))
        prog = inproc.step_program(m, contexts)
        a = inproc.machine.run(prog, validate=False).outputs
        b = sharded.machine.run(prog, validate=False).outputs
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), key
    assert ex.devices_used == 2


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, sys
    sys.path.insert(0, sys.argv[1] + "/src")
    import numpy as np
    from repro.core import dlegion
    from repro.core.scheduler import plan_stage
    from repro.core.sparsity import ztb_from_weight
    from repro.legion import Machine, ShardedExecutor, synthesize_operands
    from repro.core.workloads import (
        ATTN_SCORE, HEAD_PER_UNIT, N_PARTITION, QKV_PROJ, GEMMWorkload)

    cfg = dlegion()
    out = {}
    for bits in (2, 4, 8):
        for ztb in (0.0, 0.5):
            w = GEMMWorkload(stage=QKV_PROJ, m=32, k=256, n=128,
                             weight_bits=bits, count=8, shared_input=True,
                             mapping=HEAD_PER_UNIT)
            ex = ShardedExecutor()
            rep = Machine(cfg, backend=ex).run(w, ztb_sparsity=ztb)
            out[f"w2_{bits}_{ztb}"] = rep.outputs
            out[f"used_w2_{bits}_{ztb}"] = np.array(ex.devices_used)
    w = GEMMWorkload(stage=ATTN_SCORE, m=32, k=128, n=128, weight_bits=8,
                     count=4, kv_group=2, mapping=N_PARTITION)
    plan = plan_stage(cfg, w)
    x, weights = synthesize_operands(w, seed=9)
    masked = weights.copy().astype(np.int8)
    masked[0, : plan.assignments[0].k_window, :] = 0
    books = [ztb_from_weight(np.asarray(m), block_k=cfg.d, block_n=cfg.d,
                             window=cfg.cores) for m in masked]
    ex = ShardedExecutor()
    out["w8"] = Machine(cfg, backend=ex).run(plan, x, weights).outputs
    out["w8_books"] = Machine(cfg, backend=ex).run(plan, x, weights,
                                                   ztb=books).outputs
    out["used_w8"] = np.array(ex.devices_used)
    np.savez(sys.argv[2], **out)
    print("JAX SHARDED OK")
""")


def test_bit_exact_against_the_jax_sharded_executor(tmp_path):
    """The JAX ShardedExecutor on 4 forced host devices against the port's
    on 4 CPU shards: outputs bit for bit, devices_used equal."""
    script = tmp_path / "jax_sharded.py"
    script.write_text(JAX_SCRIPT)
    dump = tmp_path / "jax_sharded.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(script), os.path.abspath(ROOT), str(dump)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX SHARDED OK" in proc.stdout
    want = np.load(dump)
    for bits in (2, 4, 8):
        for ztb in (0.0, 0.5):
            machine, ex = _sharded()
            got = machine.run(_w2(bits), ztb_sparsity=ztb).outputs
            assert np.array_equal(got, want[f"w2_{bits}_{ztb}"]), (bits, ztb)
            assert ex.devices_used == int(want[f"used_w2_{bits}_{ztb}"])
    w = _w8()
    plan = plan_stage(CFG, w)
    x, weights = synthesize_operands(w, seed=9)
    masked = weights.copy().astype(np.int8)
    masked[0, : plan.assignments[0].k_window, :] = 0
    books = [ztb_from_weight(np.asarray(m), block_k=CFG.d, block_n=CFG.d,
                             window=CFG.cores) for m in masked]
    machine, ex = _sharded()
    assert np.array_equal(machine.run(plan, x, weights).outputs, want["w8"])
    assert np.array_equal(machine.run(plan, x, weights, ztb=books).outputs,
                          want["w8_books"])
    assert ex.devices_used == int(want["used_w8"])


def test_in_process_executor_is_the_default():
    assert isinstance(Machine(CFG, device="cpu").backend, InProcessExecutor)
