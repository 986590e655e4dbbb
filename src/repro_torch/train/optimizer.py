"""Hand-rolled AdamW + schedules over trees of tensors (nested dicts of
parameters), the port of ``repro.train.optimizer``.

The update is functional, as in the JAX package: it returns new parameter
and moment tensors and leaves its inputs as they were, so a state can be
stepped twice (tests compare two step functions from one state).  Each
leaf is updated on its own, with the temporaries of one leaf alive at a
time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch

from repro_torch.obs import spans


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples, lists and
    NamedTuples (``None`` stays ``None``), zipped with ``rest``; dict keys
    in sorted order, as ``jax.tree`` takes them (so leaf order, and the
    order of sums over leaves, is the JAX package's)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        vals = [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(
            tree)(vals)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Any              # first moment (tree like params, float32)
    nu: Any              # second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          mu=zeros, nu=tree_map(torch.clone, zeros))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, torch.Tensor]:
        """Returns (new_params, new_state, grad_norm): gradients clipped by
        their global norm, bias-corrected moments in float32, decoupled
        weight decay on matrices only, parameters cast back to their own
        type.  Under ``torch.profiler`` it runs in the span
        ``train.optimizer``."""
        with spans.span(spans.OPTIMIZER):
            return self._update(grads, state, params)

    def _update(self, grads, state: AdamWState, params):
        f32 = torch.float32
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(f32)
        bc2 = 1 - b2 ** step.to(f32)
        lr = self._lr(step)

        def leaf(p, g, m, v):
            # in-place ops only on this leaf's fresh temporaries: each
            # rounds as its out-of-place form, as the JAX expression does
            g = g.to(f32) * scale
            m = b1 * m
            m += (1 - b1) * g
            v = b2 * v
            v += (1 - b2) * g * g
            del g
            delta = torch.div(v, bc2).sqrt_().add_(self.eps)
            delta = torch.div(m, bc1).div_(delta)
            if p.ndim >= 2:   # decoupled weight decay on matrices only
                delta += self.weight_decay * p.to(f32)
            return (p.to(f32) - lr * delta).to(p.dtype), m, v

        out = tree_map(leaf, params, grads, state.mu, state.nu)
        return (_pick(out, 0), AdamWState(step, _pick(out, 1), _pick(out, 2)),
                gnorm)


def _pick(tree, i: int):
    """The ``i``-th of each leaf's result tuple, in the tree's layout."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    """lr(step) for a 0-d integer step tensor: linear warmup, then cosine
    decay to ``min_ratio * base_lr`` at ``total``."""
    def lr(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr
