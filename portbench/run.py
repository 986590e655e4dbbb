"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Everything about the cell is found by name
through ``BENCHMARK.json``: its configuration file, its traffic mix
(``traffic/<mix>.json``), the driver of the mix's kind
(``kinds/<kind>.py``), the reference of the configuration's family
(``reference/<family>.py``), its limits (``limits/<workload>.json``) and
each per-layer metric's reader (``metrics/<name>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).  Without a CUDA card, with fewer
cards than the cell asks for, outside a checkout of the program, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_started() -> float:
    """Wall time at which this process started (``/proc``; now where that
    cannot be read)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_started()


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernels' own libraries: ``build/kernels``)."""
    cache = root / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def cell_context(root: Path, workload: str) -> Dict:
    """The cell's entries and files, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"unknown workload {workload!r}; known: "
                      f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"])
                        .read_text())
    from portbench import compare, gen

    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {
        "cell": cell, "config": config,
        "traffic": gen.load(root, cell["traffic"]),
        "limits": compare.load_limits(
            root / "portbench" / "limits" / f"{workload}.json"),
        "per_layer": [m["name"] for m in per_layer],
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device=None, shrink=None) -> Dict:
    """One run of ``workload``: the result line's object.  ``device``
    None takes the CUDA card and refuses without one; the tests pass
    ``"cpu"`` and ``shrink``, {"as_run": {...}, "traffic": {...}} laid
    over the cell's configuration and traffic."""
    ctx = cell_context(root, workload)
    import torch

    # the host only dispatches: one thread, no pool spinning beside it
    torch.set_num_threads(1)
    for key, part in (shrink or {}).items():
        target = ctx["config"] if key == "as_run" else ctx
        target[key] = {**target[key], **part}

    if device is None:
        chips = ctx["cell"]["chips"]
        if not torch.cuda.is_available():
            raise Refused("no CUDA card is available")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell asks for {chips} cards; "
                          f"{torch.cuda.device_count()} are available")
        device = "cuda"
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        raise Refused(f"no program to measure: {src / 'repro_torch'} "
                      "is missing")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from portbench import kinds

    ctx.update(seed=seed, seconds=seconds, trace=traced, device=device,
               started=STARTED)
    out = kinds.load(ctx["traffic"]["kind"]).run(ctx)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that the benchmark may not use: "
                      f"{found}")
    cuda = torch.device(device).type == "cuda"
    out["metrics"] = {k: {"value": v, "unit": ctx["units"][k]}
                      for k, v in out["metrics"].items()}
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1, **out["device"],
        "power": power_limit() if cuda else "none"}
    return out


LINE_KEYS = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dump", help="also write the readings and the traced "
                   "span's summary to this JSON file")
    args = p.parse_args(argv)
    set_cache_dirs(ROOT)
    try:
        out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    if args.dump:
        Path(args.dump).write_text(json.dumps(
            {k: out[k] for k in ("readings", "trace") if k in out}))
    print(json.dumps({k: out[k] for k in LINE_KEYS if k in out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
