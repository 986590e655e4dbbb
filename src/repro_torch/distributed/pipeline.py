"""GPipe-style pipeline parallelism over a process group, the port of
``repro.distributed.pipeline``.

Stage ``s`` of the schedule is rank ``s`` of ``group``:

  * each rank holds its own stage's parameters (the JAX package shards a
    stage-major ``[S, ...]`` tree over its ``stage`` axis; here the caller
    hands each rank its slice);
  * M microbatches flow through S stages in M + S - 1 ticks; at each tick
    every stage computes its resident microbatch and ships the activation
    to the next stage, point to point (the JAX ``ppermute``), so the idle
    share is (S - 1) / (M + S - 1), the standard GPipe trade;
  * the last stage's outputs reach every rank by a masked ``all_reduce``
    (the JAX package's masked ``psum``).

The schedule is differentiable, as the JAX one is through ``shard_map``:
the backward runs the ticks in reverse, each stage recomputing its stage
function from the input it saved and shipping the input's gradient to the
stage before it (the transposed permutes).  Every rank is taken to hold
the same loss of the replicated outputs; the microbatches' gradient, which
stage 0 computes, is summed over the group so that every rank has it.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_leaves, tree_map


def _peers(group, s: int, n_stages: int):
    """Global ranks of the stages after and before stage ``s``."""
    def rank(i):
        return dist.get_global_rank(group, i) if group is not None else i
    return (rank(s + 1) if s + 1 < n_stages else None,
            rank(s - 1) if s > 0 else None)


def _exchange(send: Optional[torch.Tensor], to, recv_like: torch.Tensor,
              frm, group) -> Optional[torch.Tensor]:
    """Send ``send`` to rank ``to`` and receive a tensor like ``recv_like``
    from rank ``frm`` (either may be None) in one batch."""
    ops, got = [], None
    if to is not None and send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, group))
    if frm is not None:
        got = torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, got, frm, group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return got


def _forward(stage_fn, params, microbatches, group):
    """The forward schedule: (outputs on every rank, this stage's input at
    each tick)."""
    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    nxt, prv = _peers(group, s, n_stages)
    m = microbatches.shape[0]
    zeros = torch.zeros_like(microbatches[0])
    buf_in, inputs = zeros, []
    outputs = torch.zeros_like(microbatches)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t (zeros once drained)
        if s == 0:
            x = microbatches[t] if t < m else zeros
        else:
            x = buf_in
        inputs.append(x)
        y = stage_fn(params, x)
        # ship to the next stage (the last stage sends nowhere)
        buf_in = _exchange(y, nxt, zeros, prv, group)
        # the last stage emits microbatch t - (S - 1) at tick t
        idx = t - (n_stages - 1)
        if s == n_stages - 1 and idx >= 0:
            outputs[idx] = y
    # broadcast the last stage's buffer to every stage
    outputs = outputs * (1.0 if s == n_stages - 1 else 0.0)
    dist.all_reduce(outputs, group=group)
    return outputs, inputs


class _GPipe(torch.autograd.Function):
    """The schedule with its reverse: ``forward(stage_fn, unflatten, group,
    microbatches, *param_leaves)``."""

    @staticmethod
    def forward(ctx, stage_fn, unflatten, group, microbatches, *leaves):
        outputs, inputs = _forward(stage_fn, unflatten(leaves), microbatches,
                                   group)
        ctx.stage_fn, ctx.unflatten, ctx.group = stage_fn, unflatten, group
        ctx.inputs, ctx.m = inputs, microbatches.shape[0]
        ctx.save_for_backward(*leaves)
        return outputs

    @staticmethod
    def backward(ctx, grad_out):
        group, m = ctx.group, ctx.m
        n_stages = dist.get_world_size(group)
        s = dist.get_rank(group)
        nxt, prv = _peers(group, s, n_stages)
        leaves = ctx.saved_tensors
        tracked = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        wanted = [p for p in tracked if p.requires_grad]
        dparams: List[Optional[torch.Tensor]] = [
            torch.zeros_like(p) if p.requires_grad else None for p in tracked]
        zeros = torch.zeros_like(grad_out[0])
        dmb = torch.zeros_like(grad_out)
        ticks = m + n_stages - 1
        pending = zeros          # the input's gradient of the later tick
        for t in reversed(range(ticks)):
            # stage s + 1 ships the gradient of its input at tick t + 1,
            # which is this stage's output at tick t (the last tick's
            # outputs go nowhere)
            dy = (_exchange(pending, prv, zeros, nxt, group)
                  if t < ticks - 1 else zeros)
            idx = t - (n_stages - 1)
            if s == n_stages - 1:
                dy = grad_out[idx] if idx >= 0 else zeros
            if not 0 <= t - s < m:
                pending = zeros  # a filling or draining tick: no gradient
                continue
            with torch.enable_grad():
                x = ctx.inputs[t].detach().requires_grad_()
                y = ctx.stage_fn(ctx.unflatten(tracked), x)
                grads = torch.autograd.grad(y, [x] + wanted, dy,
                                            allow_unused=True)
            pending = grads[0] if grads[0] is not None else zeros
            it = iter(grads[1:])
            for i, p in enumerate(tracked):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        dparams[i] += g
            if s == 0:
                dmb[t] = pending
        # the microbatches are the same on every rank: the gradient stage 0
        # computed is summed over the group, so every rank holds it
        dist.all_reduce(dmb, group=group)
        return (None, None, None, dmb, *dparams)


def gpipe(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
          group=None) -> torch.Tensor:
    """``[M, ...]``: ``microbatches`` after passing through all S stages,
    ``stage_fn(stage_params, x)`` (same shape in and out) on rank ``s`` of
    ``group`` being stage ``s``.  Every rank passes the same microbatches
    and gets the same result; under autograd, each rank's gradients are
    those of its own stage's parameters and of the microbatches."""
    leaves = tree_leaves(stage_params)

    def unflatten(flat):
        it = iter(flat)
        return tree_map(lambda _: next(it), stage_params)

    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [microbatches, *leaves]):
        return _GPipe.apply(stage_fn, unflatten, group, microbatches,
                            *leaves)
    return _forward(stage_fn, stage_params, microbatches, group)[0]


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    """GPipe idle fraction: a schedule planning helper."""
    return (n_stages - 1) / (microbatches + n_stages - 1)
