"""Checkpointing: async save, manifest, restore onto a device — the port of
``repro.train.checkpoint``, with the same on-disk layout, so that either
package restores what the other wrote:

    ckpt_dir/
      step_00000100/
        manifest.json        # step, meta, leaf paths, exotic dtypes
        structure.json       # the tree's containers
        arrays.npz           # flat {path: np.ndarray}
      LATEST                 # text file: "step_00000100" (atomic rename)

Leaves are host copies of the tensors.  numpy-native dtypes go into the npz
as they are; bfloat16 (and the float8 types) have no numpy dtype here, so
they are stored as raw bytes with ``{"dtype": "bfloat16", "shape": [...]}``
in the manifest, exactly as the JAX package writes them, and come back as a
bfloat16 view of the bytes (no ``ml_dtypes``).  Saves snapshot the tree to
host memory synchronously, write on a background thread and commit by an
atomic rename of the LATEST pointer, so a crash mid-save never corrupts the
restore point.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# stored as raw bytes: torch dtypes without a numpy counterpart
_EXOTIC = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def _host(leaf):
    """A host snapshot of one leaf: a numpy array, or (raw uint8 bytes,
    exotic entry) for a dtype numpy lacks."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).split(".")[1]
    if name in _EXOTIC:
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw, {"dtype": name, "shape": list(t.shape)}
    return t.numpy(), None


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (tuple, list)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        elif node is None:
            pass   # recorded in the structure, nothing to store
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _decode(arrays: Dict[str, np.ndarray], exotic: Dict,
            device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, a in arrays.items():
        if k in exotic:
            name = exotic[k]["dtype"]
            if name not in _EXOTIC:
                raise ValueError(f"{k}: stored dtype {name} is not one this "
                                 f"port reads ({sorted(_EXOTIC)})")
            t = torch.from_numpy(np.array(a)).view(
                _EXOTIC[name]).reshape(exotic[k]["shape"])
        else:
            t = torch.from_numpy(np.array(a))     # a copy; 0-d stays 0-d
        out[k] = t.to(device)
    return out


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {k: _tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
        return [_tree_structure(v) for v in tree]
    if tree is None:
        return "__none__"
    return "__leaf__"


def _unflatten(structure, flat: Dict, prefix=""):
    if isinstance(structure, dict):
        return {
            k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in structure.items()
        }
    if isinstance(structure, list):
        return tuple(
            _unflatten(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(structure)
        )
    if structure == "__none__":
        return None
    return flat[prefix]


def _unflatten_like(example, flat: Dict, prefix=""):
    """Rebuild into the exact container types of ``example`` (dicts,
    NamedTuples, tuples/lists, None leaves), so NamedTuple states
    round-trip."""
    if isinstance(example, dict):
        return {
            k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in ((k, example[k]) for k in sorted(example))
        }
    if hasattr(example, "_fields"):   # namedtuple
        vals = [
            _unflatten_like(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(example)
        ]
        return type(example)(*vals)
    if isinstance(example, (tuple, list)) and not hasattr(example, "shape"):
        return type(example)(
            _unflatten_like(v, flat, f"{prefix}/{i}")
            for i, v in enumerate(example)
        )
    if example is None:
        return None
    return flat[prefix]


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, meta: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write to disk async."""
        arrays, exotic = {}, {}
        for k, leaf in _flatten(tree).items():
            arrays[k], entry = _host(leaf)
            if entry is not None:
                exotic[k] = entry
        structure = _tree_structure(tree)
        manifest = {
            "step": int(step),
            "meta": meta or {},
            "paths": sorted(arrays),
            "exotic": exotic,
        }
        self.wait()   # one in-flight save at a time

        def write():
            name = f"step_{step:08d}"
            tmp = tempfile.mkdtemp(dir=self.dir)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "structure.json"), "w") as f:
                json.dump(structure, f)
            final = os.path.join(self.dir, name)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            # atomic commit
            latest_tmp = os.path.join(self.dir, ".LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(name)
            os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.dir) if d.startswith("step_")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            return int(f.read().strip().split("_")[1])

    def restore(
        self, step: Optional[int] = None, *, device: DeviceLike = None,
        example: Any = None,
    ) -> Tuple[int, Any]:
        """Load a checkpoint as tensors on ``device`` (default: the CUDA
        card); ``example`` preserves container types (NamedTuple
        states)."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        name = f"step_{step:08d}"
        with np.load(os.path.join(self.dir, name, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(self.dir, name, "manifest.json")) as f:
            manifest = json.load(f)
        flat = _decode(arrays, manifest.get("exotic", {}), device)
        if example is not None:
            return step, _unflatten_like(example, flat)
        with open(os.path.join(self.dir, name, "structure.json")) as f:
            structure = json.load(f)
        return step, _unflatten(structure, flat)
