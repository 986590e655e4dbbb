"""What a run imports: never JAX or the JAX package (top-level names
compared whole, since ``repro_torch`` begins with ``repro``), and the
reference nothing of the program."""
from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

RUN = """
import sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
from pathlib import Path
from portbench.run import run_cell, forbidden_modules
{body}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(forbidden_modules())
"""


def _modules(body):
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(src=str(ROOT / "src"),
                                          root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    top, forbidden = proc.stdout.strip().splitlines()[-2:]
    return eval(top), eval(forbidden)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import run

    for name in ("jaxtyping", "repro_torch", "repro_torch.models",
                 "reprolib"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {"jaxtyping", "repro_torch"}
    for name in ("jax.numpy", "repro.models", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"jax", "repro", "flax"} <= set(run.forbidden_modules())


def test_a_run_loads_no_jax_and_no_jax_package():
    body = ("from conftest import shrink\n"
            "run_cell(Path({root!r}), 'zamba2-7b-30l.train-4k', 7, 0.1, "
            "True, device='cpu', shrink=shrink('zamba2-7b-30l.train-4k'))"
            ).format(root=str(ROOT))
    body = f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n" \
        + body
    top, forbidden = _modules(body)
    assert forbidden == []
    assert "repro_torch" in top


def test_the_reference_imports_nothing_of_the_program():
    body = ("import portbench.reference.dense, portbench.reference.hybrid\n"
            "import portbench.compare, portbench.gen\n"
            "import portbench.cost.model_dense, portbench.cost.model_hybrid")
    top, forbidden = _modules(body)
    assert "repro_torch" not in top and forbidden == []
