"""Faults planted under the timed path, to show that the comparison
catches them: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; one gradient altered where
autograd produces it (the first stacked leaf's layer-0 slice doubled).
Used by ``portbench.gaps`` and the tests, never by a benchmark run."""
from __future__ import annotations

import dataclasses

FAULTS = ("unchanged", "half_batch", "altered")


def plant(fault: str, api, build_step):
    """The program's train step (``build_step(api)``) with ``fault``
    planted."""
    if fault == "half_batch":
        from repro_torch.models.common import cross_entropy

        def loss(params, batch):
            logits = api.train_logits(params, batch)
            half = logits.shape[1] // 2
            return cross_entropy(logits[:, :half], batch["targets"][:, :half])

        api = dataclasses.replace(api, loss=loss)
    elif fault == "altered":
        inner = api.loss

        def loss(params, batch):
            leaf = _first_stacked(params["blocks"])

            def double(g):
                g = g.clone()
                g[0] *= 2
                return g

            leaf.register_hook(double)
            return inner(params, batch)

        api = dataclasses.replace(api, loss=loss)
    elif fault != "unchanged":
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    step = build_step(api)
    if fault == "unchanged":
        real = step

        def step(state, batch):
            return state, real(state, batch)[1]

    return step


def _first_stacked(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree
