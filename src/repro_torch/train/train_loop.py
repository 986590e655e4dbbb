"""Train-step builder: QAT loss, gradient, grad accumulation, AdamW — the
single-device path of ``repro.train.train_loop``.

``build_train_step`` returns a function of (state, batch) that computes the
loss, its gradient by autograd (through the flash kernels' backward on the
card) and the optimizer update.  ``grad_shardings`` and
``build_compressed_train_step`` (the pod-axis int8 gradient exchange)
belong to the distributed slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.train.optimizer import (
    AdamW, AdamWState, tree_leaves, tree_map,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[Any] = None   # error-feedback state (compressed variant)


def init_train_state(api, optimizer: AdamW, seed) -> TrainState:
    """Fresh parameters from ``seed`` (an int or ``torch.Generator``) on
    the model's device and the optimizer's zero state."""
    params = api.init(seed)
    return TrainState(params=params, opt=optimizer.init(params))


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` with respect to every
    leaf of ``params``; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives it.  The parameters are not modified."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    inputs = tree_leaves(tracked)
    loss = loss_fn(tracked, batch)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    filled = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(inputs, grads)])
    return loss.detach(), tree_map(lambda _: next(filled), params)


def build_train_step(
    api, optimizer: AdamW, *, grad_accum: int = 1,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Step: loss -> grad -> AdamW.

    ``grad_accum > 1`` splits the step's batch along its first axis into
    microbatches taken one after another, their gradients summed in
    float32 and averaged (constant activation memory).
    """

    def microbatch(batch, i):
        return {k: x.reshape(grad_accum, -1, *x.shape[1:])[i]
                for k, x in batch.items()}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if grad_accum == 1:
            loss, grads = value_and_grad(api.loss, state.params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=api.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for i in range(grad_accum):
                l, g = value_and_grad(api.loss, state.params,
                                      microbatch(batch, i))
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)

        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt.step}
        return TrainState(params, opt, state.ef), metrics

    return step
