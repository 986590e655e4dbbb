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
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.obs.metrics, repro_torch.obs.timeline\n"
        "import repro_torch.obs.roofline, repro_torch.obs.loadgen\n"
        "from repro_torch.obs import TimelineTracer, run_load\n"
        "import repro_torch.serve.paged_kv, repro_torch.serve.admission\n"
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
                                   "LegionServeBackend", "params_from_jax"])
def test_entry_points_raise_without_device_and_card(entry):
    _no_card()
    import repro_torch.configs as configs
    from repro_torch.convert import params_from_jax
    from repro_torch.core import dlegion
    from repro_torch.legion import Machine
    from repro_torch.models import build_model
    from repro_torch.serve import LegionServeBackend

    cfg = configs.reduced(configs.get_config("bitnet-1.58b"))
    params = build_model(cfg, device="cpu").init(0)
    calls = {
        "build_model": lambda: build_model(cfg),
        "Machine": lambda: Machine(dlegion()),
        "LegionServeBackend": lambda: LegionServeBackend(dlegion(), cfg,
                                                         params),
        "params_from_jax": lambda: params_from_jax({"w": [[1.0]]}),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


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
