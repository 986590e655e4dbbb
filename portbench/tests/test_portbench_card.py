"""On the card, at each cell's own size: the program passes its limits
and the control (the reference computed in fp8 in the program's place)
fails them, on three seeds.  Skipped without a card.

    python3 -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""
from __future__ import annotations

import gc

import pytest
import torch

from conftest import CELLS, ROOT
from portbench import compare, gen
from portbench.kinds import train
from portbench.run import cell_context

SEEDS = (2024101801, 2024101802, 2024101803)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at full size")
    ctx = cell_context(ROOT, cell)
    spec, opt = ctx["config"]["as_run"], ctx["config"]["train"]
    for seed in SEEDS:
        prog = train.Program(spec, opt, seed, "cuda")
        batches = gen.TokenBatches(ctx["traffic"], spec["vocab"], seed,
                                   prog.device)
        readings, kept = prog.first_steps(batches)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        base = train.reference_readings(spec, opt, seed, kept, "cuda")
        control = train.reference_readings(spec, opt, seed, kept, "cuda",
                                           "fp8")
        ok, checks = compare.judge(compare.gaps(readings, base),
                                   ctx["limits"])
        assert ok, (seed, checks)
        ok, checks = compare.judge(compare.gaps(control, base),
                                   ctx["limits"])
        assert not ok, (seed, checks)
