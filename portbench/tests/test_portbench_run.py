"""A tiny dry pass of a run to its result, on the CPU; and the command's
refusals where it cannot measure."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, shrink
from portbench.run import LINE_KEYS, cell_context, run_cell


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_reaches_its_result(cell, traced):
    out = run_cell(ROOT, cell, 2 ** 31 + 12345, 0.2, traced,
                   device="cpu", shrink=shrink(cell))
    line = json.loads(json.dumps({k: out[k] for k in LINE_KEYS if k in out}))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(cell_context(ROOT, cell)["limits"])
    assert line["device"]["platform"] == "cpu"
    if traced:
        # no device ran anything: no device metric is read from a CPU run
        assert line["metrics"] == {}
        assert line["device"]["busy_s"] == 0.0
        assert "breakdown" in line
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s",
                                        "train_peak_gb", "setup_s"}


def _command(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _command(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_command_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
