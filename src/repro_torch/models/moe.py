"""Token-choice top-k MoE with capacity-based dispatch.

The port of ``repro.models.moe``.  Routing is per batch row (GShard-style
grouped capacity): each row routes its own S tokens with capacity
``cf * k * S / E``, positions within an expert from a per-row cumsum in
token-major, slot-minor order, which decides the tokens that drop.  The
JAX package's sharding constraints are the identity on one device and are
gone.  The expert products are plain einsums there and here (no Pallas
kernel computes them).

The ZTB analogy: an expert with no routed tokens is a fully-sparse window,
which the Legion runtime skips (``legion.lowering.lower_moe``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import dense_init
from repro_torch.quant.bitnet import fake_quant_act, fake_quant_weight


def init_moe_params(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Router ``[d, n_experts]`` float32 (it only ever emits real expert
    ids); ``w1`` / ``w3`` ``[E_total, d, f]`` and ``w2`` ``[E_total, f, d]``
    over the padded expert count, the dummy experts random as in the JAX
    package."""
    e, d, f = cfg.n_experts_total, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device)
        return (w * scale).to(dtype)

    return {
        "router": dense_init(gen, d, cfg.n_experts, torch.float32, device),
        "w1": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w3": normal((e, d, f), 1.0 / math.sqrt(d)),
        "w2": normal((e, f, d), 1.0 / math.sqrt(f)),
    }


def route(p, cfg, x: torch.Tensor):
    """Router probabilities ``[B, S, n_experts]`` (float32) and the top-k
    of each token: ``(probs, gates, idx)``, gates renormalised over the k.

    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them: a
    stable descending sort, where ``torch.topk`` gives no such promise."""
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :cfg.top_k], order[..., :cfg.top_k]
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def assign_slots(idx: torch.Tensor, n_experts_total: int, cap: int):
    """Each (token, slot)'s position within its expert, per batch row, in
    token-major, slot-minor order: ``(e_flat, slot_pos, keep)``, all
    ``[B, S*k]``.  A token past the capacity is dropped (``keep`` false)
    and parked at slot ``cap - 1``, where it adds zero."""
    b = idx.shape[0]
    e_flat = idx.reshape(b, -1)
    onehot = torch.nn.functional.one_hot(e_flat, n_experts_total)
    cum = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = torch.gather(cum, 2, e_flat[..., None])[..., 0]
    keep = pos_in_e < cap
    return e_flat, torch.where(keep, pos_in_e, cap - 1), keep


def moe_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d].  Capacity-dropped top-k routing."""
    b, s, d = x.shape
    e, k = cfg.n_experts_total, cfg.top_k
    cap = int(cfg.capacity_factor * k * s / cfg.n_experts + 1)
    quantize = cfg.quantization == "bitnet"

    _, gates, idx = route(p, cfg, x)
    e_flat, slot_pos, keep = assign_slots(idx, e, cap)
    rows = torch.arange(b, device=x.device)[:, None].expand_as(e_flat)

    # dispatch into [B, E, cap, d]: an accumulating scatter, because a
    # dropped token lands on slot cap - 1 (with value zero) beside the kept
    # token that holds it
    x_rep = torch.repeat_interleave(x, k, dim=1)             # [B, S*k, d]
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((rows, e_flat, slot_pos),
                   torch.where(keep[..., None], x_rep, 0), accumulate=True)

    # the weights are fake-quantized as one tensor over all E_total
    # experts: the absmean gamma includes the dummy ones, as in JAX
    w1, w2, w3 = p["w1"], p["w2"], p["w3"]
    if quantize:
        buf = fake_quant_act(buf)
        w1, w2, w3 = (fake_quant_weight(w) for w in (w1, w2, w3))
    h = torch.nn.functional.silu(
        torch.einsum("becd,edf->becf", buf, w1)
    ) * torch.einsum("becd,edf->becf", buf, w3)
    if quantize:
        h = fake_quant_act(h)
    out_buf = torch.einsum("becf,efd->becd", h, w2)

    # combine: gather each (token, slot)'s result, weight by its gate
    y_slots = out_buf[rows, e_flat, slot_pos]                # [B, S*k, d]
    y_slots = torch.where(keep[..., None], y_slots, 0)
    y = (y_slots.reshape(b, s, k, d).to(torch.float32)
         * gates[..., None]).sum(dim=2)
    return y.to(x.dtype)


def load_balance_loss(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss (mean prob x mean dispatch per expert),
    differentiable through the router probabilities."""
    probs, _, idx = route(p, cfg, x.reshape(-1, x.shape[-1]))
    dispatch = torch.nn.functional.one_hot(
        idx, cfg.n_experts).to(torch.float32).sum(dim=1)
    return cfg.n_experts * torch.mean(probs.mean(dim=0)
                                      * dispatch.mean(dim=0))


def moe_lowering_spec(cfg, *, tokens: int = 16, seed: int = 0):
    """The config's MoE FFN block as a
    :class:`repro_torch.legion.lowering.MoESpec` — the D-Legion
    workload-zoo view of this model: the router's top-k becomes
    program-level ZTB sparsity (an expert with no routed tokens is a
    fully-sparse window, exactly the analogy documented above)."""
    from repro_torch.legion.lowering import MoESpec

    return MoESpec(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, tokens=tokens, weight_bits=cfg.weight_bits,
        layers=cfg.layers, seed=seed, name=cfg.name,
    )
