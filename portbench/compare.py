"""The numbers that decide ``correct`` for a training cell, and their
judgment against the cell's limits (``limits/<cell>.json``).

Three readings of the first three training steps, taken the same way from
the program and from the reference:

- each step's loss;
- each parameter slice's gradient norm at step 1, the gradient as the
  optimizer takes it in (read from the program's first moment, which after
  one step holds (1 - b1) x the clipped gradient, and its reported global
  norm, which gives the clip);
- each slice's norm of the change the three steps made, as step 4 reads
  the parameters.

A slice is one layer's part of a stacked leaf, or a whole unstacked leaf.
Gaps compare norms, not the norm of the difference: for a slice,
|program - reference| over the larger of the reference's norm of that
slice and of the median slice.  ``grad_gap`` and ``change_gap`` are the
worst slice's gap, ``grad_median_gap`` and ``change_median_gap`` the
median slice's (steady from seed to seed where a few small leaves' gaps
swing with bfloat16 rounding), ``loss_gap`` the worst step's.  Slices
whose reference gradient is under a thousandth of the median slice's move
by round-off alone and are left out of the change.  A cell's limits file
names the numbers it compares; the others are printed, not judged.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, Sequence

import torch

from portbench.reference.common import F32, Leaf, get, make_leaf

ZERO_GRAD_SHARE = 1e-3


def change_norms(params, leaves: Sequence[Leaf], seed: int, device
                 ) -> Dict[str, float]:
    """Each slice's norm of params minus the parameters made from the seed
    (made again one leaf at a time)."""
    out = {}
    for i, leaf in enumerate(leaves):
        diff = (get(params, leaf.path).to(F32)
                - make_leaf(leaf, seed, i, device).to(F32))
        name = ".".join(leaf.path)
        if leaf.stacked:
            norms = torch.linalg.vector_norm(
                diff.reshape(diff.shape[0], -1), dim=1).tolist()
            out.update({f"{name}[{j}]": v for j, v in enumerate(norms)})
        else:
            out[name] = torch.linalg.vector_norm(diff).item()
        del diff
    return out


def _slices(prog: Dict[str, float], ref: Dict[str, float], names):
    """(worst, its slice), (median, its slice) of the slices' gaps."""
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names}
    order = sorted(names, key=lambda n: (not math.isfinite(gaps[n]),
                                         gaps[n]))
    mid = order[(len(order) - 1) // 2]
    return (gaps[order[-1]], order[-1]), (gaps[mid], mid)


def gaps(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """{number: {"value", "where"}} of the program's readings against the
    reference's."""
    out = {}
    loss = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    worst_step = max(range(len(loss)),
                     key=lambda i: (not math.isfinite(loss[i]), loss[i]))
    out["loss_gap"] = {"value": loss[worst_step],
                       "where": f"step {worst_step + 1}"}
    names = list(ref["grad"])
    floor = statistics.median(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= ZERO_GRAD_SHARE * floor]
    for key, which in (("grad", names), ("change", moving)):
        worst, mid = _slices(prog[key], ref[key], which)
        out[f"{key}_gap"] = {"value": worst[0], "where": worst[1]}
        out[f"{key}_median_gap"] = {"value": mid[0], "where": mid[1]}
    return out


def load_limits(path: Path) -> Dict[str, float]:
    return json.loads(path.read_text())["limits"]


def judge(found: Dict[str, Dict], limits: Dict[str, float]):
    """(correct, checks): every number finite and at or under its limit;
    checks hold each number beside its limit, in the limits' order."""
    checks = {name: {"value": found[name]["value"], "limit": limit}
              for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
