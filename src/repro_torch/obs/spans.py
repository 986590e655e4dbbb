"""Wall-clock spans of the train step: ``torch.profiler`` ranges
(``record_function``) that exist only while a profiler records.

There is no switch: with no profiler recording, :func:`span` returns one
shared null context (a flag read, ~0.4 µs), and the untraced step's
autograd graph is the one it always was.  Under ``torch.profiler`` every
span is a host-op event on Kineto's clock, so each kernel of the trace and
each idle gap of the card sits under the span the host was in, and a span's
``device_time_total`` sums the device time of what it launched.

The spans, each name prefixed ``repro_torch.``:

- ``train.forward``: the loss's forward, one a microbatch
  (``train.train_loop.value_and_grad``);
- ``train.backward``: the whole backward, opened on the thread that runs it
  (CUDA autograd runs it on the engine's device thread, which a span on the
  calling thread would miss) and closed when its graph task ends;
- ``train.optimizer``: ``AdamW.update`` whole (global norm, clip, leaves);
- ``models.layer``: one layer's forward, or the hybrid's shared block;
  ``models.layer_recompute`` where that forward runs inside a backward,
  as a remat's recomputation does;
- ``quant.fake_quant_weight``, ``quant.fake_quant_act``: each call of
  ``quant.bitnet``'s fake-quantizers, in the forward and in recomputation.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

FORWARD = "repro_torch.train.forward"
BACKWARD = "repro_torch.train.backward"
OPTIMIZER = "repro_torch.train.optimizer"
LAYER = "repro_torch.models.layer"
LAYER_RECOMPUTE = "repro_torch.models.layer_recompute"
FAKE_QUANT_WEIGHT = "repro_torch.quant.fake_quant_weight"
FAKE_QUANT_ACT = "repro_torch.quant.fake_quant_act"

# what every span is while no profiler records
NULL = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else
    :data:`NULL`."""
    if not torch.autograd._profiler_enabled():
        return NULL
    return record_function(name)


def layer_span():
    """The span of one layer's forward: :data:`LAYER_RECOMPUTE` inside a
    backward's graph task (a remat's recomputation), else :data:`LAYER`."""
    if not torch.autograd._profiler_enabled():
        return NULL
    inside_backward = torch._C._current_graph_task_id() != -1
    return record_function(LAYER_RECOMPUTE if inside_backward else LAYER)


class _OpenBackward(torch.autograd.Function):
    """The identity; its backward, the first node the engine runs, opens
    :data:`BACKWARD` on the engine's thread and queues its close for the
    end of the graph task, which the thread that ran the last node runs:
    the same engine thread, on the CPU and on the card, so that the
    profiler nests every node of the backward inside the span."""

    @staticmethod
    def forward(ctx, loss):
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, grad):
        rf = record_function(BACKWARD)
        rf.__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: rf.__exit__(None, None, None))
        return grad


def backward_span(loss: torch.Tensor) -> torch.Tensor:
    """``loss``, through the identity node that opens :data:`BACKWARD`
    while a profiler records; ``loss`` itself otherwise."""
    if not torch.autograd._profiler_enabled():
        return loss
    return _OpenBackward.apply(loss)
