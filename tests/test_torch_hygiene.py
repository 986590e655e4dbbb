"""The port stands alone: no JAX, nothing of the JAX package, no silent
CPU fallback, and a chip check that refuses to run without a card."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports_in_sources():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in _sources()
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serve, repro_torch.legion, repro_torch.models\n"
        "import repro_torch.kernels, repro_torch.convert, repro_torch.quant\n"
        "import repro_torch.configs, repro_torch.core, repro_torch.data\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.kernels.block_sparse.ops\n"
        "import repro_torch.legion.lowering, repro_torch.legion.roofline\n"
        "import repro_torch.models.moe, repro_torch.models.mamba2\n"
        "import repro_torch.models.hybrid\n"
        "import repro_torch.kernels.ssd.ops\n"
        "from repro_torch.kernels.ssd.ops import SSDScan\n"
        "from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.obs.metrics, repro_torch.obs.timeline\n"
        "import repro_torch.obs.roofline, repro_torch.obs.loadgen\n"
        "from repro_torch.obs import TimelineTracer, run_load\n"
        "import repro_torch.serve.paged_kv, repro_torch.serve.admission\n"
        "import repro_torch.train, repro_torch.train.checkpoint\n"
        "import repro_torch.train.fault_tolerance\n"
        "from repro_torch.train import AdamW, Checkpointer, TrainingRunner\n"
        "from repro_torch.convert import train_state_from_jax\n"
        "import repro_torch.distributed, repro_torch.launch\n"
        "import repro_torch.launch.roofline, repro_torch.launch.hlo_cost\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
        "import repro_torch.kernels.cost\n"
        "import repro_torch.distributed.collectives\n"
        "import repro_torch.distributed.pipeline\n"
        "from repro_torch.legion import ShardedExecutor\n"
        "from repro_torch.train.train_loop import "
        "build_compressed_train_step\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.serve_bitnet\n"
        "import repro_torch.examples.train_bitnet\n"
        "import repro_torch.examples.sparsity_dse\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


@pytest.mark.parametrize("entry", ["build_model", "Machine",
                                   "LegionServeBackend", "params_from_jax",
                                   "init_train_state", "build_train_step",
                                   "train_state_from_jax",
                                   "Checkpointer.restore", "TrainingRunner",
                                   "ShardedExecutor", "init_process_group"])
def test_entry_points_raise_without_device_and_card(entry, tmp_path):
    _no_card()
    import repro_torch.configs as configs
    from repro_torch.convert import params_from_jax, train_state_from_jax
    from repro_torch.core import dlegion
    from repro_torch.distributed import init_process_group
    from repro_torch.legion import Machine, ShardedExecutor
    from repro_torch.models import build_model
    from repro_torch.serve import LegionServeBackend
    from repro_torch.train import (
        AdamW, Checkpointer, TrainingRunner, build_train_step,
        init_train_state,
    )
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_loop import TrainState

    cfg = configs.reduced(configs.get_config("bitnet-1.58b"))
    params = build_model(cfg, device="cpu").init(0)
    calls = {
        "build_model": lambda: build_model(cfg),
        "Machine": lambda: Machine(dlegion()),
        "LegionServeBackend": lambda: LegionServeBackend(dlegion(), cfg,
                                                         params),
        "params_from_jax": lambda: params_from_jax({"w": [[1.0]]}),
        # the train path starts from a model built for the card
        "init_train_state": lambda: init_train_state(build_model(cfg),
                                                     AdamW(), 0),
        "build_train_step": lambda: build_train_step(build_model(cfg),
                                                     AdamW()),
        "train_state_from_jax": lambda: train_state_from_jax(TrainState(
            {"w": [[1.0]]}, AdamWState(0, {"w": [[0.0]]}, {"w": [[0.0]]}))),
        "Checkpointer.restore": lambda: Checkpointer(str(tmp_path)).restore(),
        "TrainingRunner": lambda: TrainingRunner(
            None, None, None, Checkpointer(str(tmp_path))),
        # every card; and an NCCL group, which needs one
        "ShardedExecutor": lambda: ShardedExecutor(),
        "init_process_group": lambda: init_process_group(
            str(tmp_path / "store"), 0, 1),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_distributed_code_catches_nothing():
    """The distributed slice's modules hold no ``except``: a failed kernel
    build or launch, or a collective that times out, raises through them
    instead of being caught and carried past."""
    import inspect

    from repro_torch.legion.machine import ShardedExecutor
    from repro_torch.models import attention

    sources = [p.read_text() for d in ("distributed", "launch")
               for p in sorted((PORT / d).glob("*.py"))]
    sources += [inspect.getsource(ShardedExecutor),
                inspect.getsource(attention._context_parallel_flash),
                inspect.getsource(attention._GatherSeq),
                inspect.getsource(attention._SumGrad)]
    assert len(sources) >= 9
    for src in sources:
        assert not re.search(r"^\s*except\b", src, re.M)


def test_ssd_wrapper_catches_nothing():
    """The SSD wrapper holds no ``except`` and no retry: a CUDA input that
    needs a gradient goes through the backward kernel or raises, never
    through the plain version."""
    src = (PORT / "kernels" / "ssd" / "ops.py").read_text()
    assert not re.search(r"^\s*except\b", src, re.M)
    assert "refuse_grad" not in src


def test_chip_smoke_refuses_without_card(tmp_path):
    _no_card()
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
