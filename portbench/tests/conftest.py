"""Shared fixtures of the benchmark's CPU tests: the checkout's root on
``sys.path`` with its ``src``, and tiny versions of each cell."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "bitnet-1.58b.train-4k": dict(
        layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16, d_ff=128,
        vocab=256),
    "zamba2-7b-30l.train-4k": dict(
        layers=4, d_model=64, n_heads=4, kv_heads=4, head_dim=16, d_ff=128,
        vocab=256, ssm_state=16, ssm_head_dim=16, ssd_chunk=32,
        attn_every=2),
}
CELLS = sorted(TINY)


def shrink(cell: str, dtype: str = "float32", seq: int = 64):
    return {"as_run": dict(TINY[cell], dtype=dtype),
            "traffic": {"seq": seq}}


@pytest.fixture
def root() -> Path:
    return ROOT
