"""Parameters and train states of the JAX package, as numpy arrays, into
the port's tensors.

``params_from_jax(jax.tree.map(np.asarray, params))`` keeps the tree (the
port uses the JAX package's layout, per-layer leaves stacked ``[L, ...]``)
and turns every leaf into a torch tensor on ``device`` of the same type
(bfloat16 included), so that both packages compute with the same
weights.  ``train_state_from_jax(jax.tree.map(np.asarray, state))`` does
the same for a whole ``TrainState`` (params, the AdamW step and moments,
and the compressed step's error-feedback state ``ef`` where it has one),
so that both packages train from the same state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_jax(np_params: Any, *, device: DeviceLike = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors (copies)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":
            # numpy knows bfloat16 only through ml_dtypes, torch.from_numpy
            # not at all: carry the bits across
            return torch.from_numpy(arr.view(np.uint16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)

    return walk(np_params)


def train_state_from_jax(np_state: Any, *, device: DeviceLike = None):
    """The JAX package's ``TrainState`` with numpy leaves (``params``,
    ``opt.step``, ``opt.mu``, ``opt.nu``, and ``ef`` or None) -> the port's
    ``TrainState``."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_loop import TrainState

    device = resolve_device(device)
    opt = np_state.opt
    step = torch.from_numpy(np.array(opt.step, dtype=np.int32)).to(device)
    return TrainState(
        params=params_from_jax(np_state.params, device=device),
        opt=AdamWState(step=step,
                       mu=params_from_jax(opt.mu, device=device),
                       nu=params_from_jax(opt.nu, device=device)),
        ef=(None if np_state.ef is None
            else params_from_jax(np_state.ef, device=device)))
