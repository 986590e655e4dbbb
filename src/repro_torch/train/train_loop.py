"""Train-step builders: QAT loss, gradient, grad accumulation, AdamW, and
the pod-axis compressed-gradient variant: the port of
``repro.train.train_loop``.

``build_train_step`` returns a function of (state, batch) that computes the
loss, its gradient by autograd (through the flash kernels' backward on the
card) and the optimizer update; ``grad_shardings`` lays DTensor gradients
out by their specs.  ``build_compressed_train_step`` runs one rank of a
``torch.distributed`` group (the JAX package's manual "pod" axis): each
rank differentiates the loss on its slice of the global batch, and the
gradients are exchanged as int8 payloads with error feedback
(``repro_torch.distributed.collectives``), carried in ``TrainState.ef``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import redistribute
from repro_torch.obs import spans
from repro_torch.train.optimizer import (
    AdamW, AdamWState, tree_leaves, tree_map,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[Any] = None   # error-feedback state (compressed variant)


def init_train_state(api, optimizer: AdamW, seed, *,
                     compressed: bool = False) -> TrainState:
    """Fresh parameters from ``seed`` (an int or ``torch.Generator``) on
    the model's device and the optimizer's zero state; ``compressed``
    adds the zero error-feedback state of the compressed step."""
    params = api.init(seed)
    ef = collectives.init_error_state(params) if compressed else None
    return TrainState(params=params, opt=optimizer.init(params), ef=ef)


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` with respect to every
    leaf of ``params``; a leaf the loss does not read gets zeros, as
    ``jax.grad`` gives it.  The parameters are not modified.  Under
    ``torch.profiler`` the forward and the backward run in the spans
    ``train.forward`` and ``train.backward`` (``repro_torch.obs.spans``)."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    inputs = tree_leaves(tracked)
    with spans.span(spans.FORWARD):
        loss = loss_fn(tracked, batch)
    loss = spans.backward_span(loss)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    filled = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(inputs, grads)])
    return loss.detach(), tree_map(lambda _: next(filled), params)


def _constrain_grads(grads, grad_shardings):
    """Each DTensor gradient redistributed to its spec in
    ``grad_shardings`` (a tree of specs like ``param_shardings``'), plain
    tensors as they are."""
    if grad_shardings is None:
        return grads
    if isinstance(grads, dict):
        return {k: _constrain_grads(v, grad_shardings[k])
                for k, v in grads.items()}
    return redistribute(grads, grad_shardings)


def build_train_step(
    api, optimizer: AdamW, *, grad_accum: int = 1,
    grad_shardings: Optional[Any] = None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Step: loss -> grad -> AdamW.

    ``grad_accum > 1`` splits the step's batch along its first axis into
    microbatches taken one after another, their gradients summed in
    float32 and averaged (constant activation memory).
    ``grad_shardings`` (a tree of specs like the parameters, from
    ``repro_torch.distributed.param_shardings``) pins the layout of
    DTensor gradients; plain tensors, which the single-device path has,
    are left as they are.
    """

    def microbatch(batch, i):
        return {k: x.reshape(grad_accum, -1, *x.shape[1:])[i]
                for k, x in batch.items()}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if grad_accum == 1:
            loss, grads = value_and_grad(api.loss, state.params, batch)
            grads = _constrain_grads(grads, grad_shardings)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=api.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for i in range(grad_accum):
                l, g = value_and_grad(api.loss, state.params,
                                      microbatch(batch, i))
                g = _constrain_grads(g, grad_shardings)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)

        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt.step}
        return TrainState(params, opt, state.ef), metrics

    return step


def build_compressed_train_step(
    api, optimizer: AdamW, group=None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Pod-axis int8 + error-feedback gradient exchange (beyond-paper opt).

    Every rank of ``group`` (the default group if None) calls the step
    with the same state and the same global batch, as the JAX step is
    called under its mesh; rank ``r`` of ``n`` differentiates the loss on
    rows ``[r b / n, (r + 1) b / n)`` of the batch (the ``P(pod)`` in-spec),
    the loss is averaged over the group (``pmean``), and the gradients
    cross it as int8 payloads with error feedback
    (``collectives.compressed_psum_pod``).  The state must carry ``ef``
    (``init_train_state(..., compressed=True)``); each rank's returned
    ``ef`` is its own residual, as each JAX pod keeps its own on its
    device (the JAX step returns it under a replicated out-spec, unchecked,
    so a host read there sees pod 0's).  Parameters and moments come out
    equal on every rank.
    """

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params, opt, ef = state
        # a caller that keeps no other reference to the old state frees its
        # error-feedback tensors once they are exchanged (BitNet-1.58B's
        # are 9.8 GB), before the update doubles the parameters and moments
        del state
        if ef is None:
            raise ValueError("the compressed step needs the error-feedback "
                             "state: init_train_state(..., compressed=True)")
        n, r = dist.get_world_size(group), dist.get_rank(group)
        local = {k: x.reshape(n, -1, *x.shape[1:])[r]
                 for k, x in batch.items()}
        loss, grads = value_and_grad(api.loss, params, local)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        loss = loss / n
        grads, ef = collectives.compressed_psum_pod(grads, ef, group)
        params, opt, gnorm = optimizer.update(grads, opt, params)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt.step}
        return TrainState(params, opt, ef), metrics

    return step
