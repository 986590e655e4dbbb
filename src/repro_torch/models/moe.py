"""Token-choice top-k MoE with capacity-based dispatch.

The port of ``repro.models.moe``.  Routing is per batch row (GShard-style
grouped capacity): each row routes its own S tokens with capacity
``cf * k * S / E``, positions within an expert from a per-row cumsum in
token-major, slot-minor order, which decides the tokens that drop.  The
expert products are plain einsums there and here (no Pallas kernel
computes them).  The JAX package's sharding constraints are kept (the
identity on plain tensors); on DTensors the block runs as
:func:`_moe_block_sharded`, each rank routing its rows and running its
experts' products.

The ZTB analogy: an expert with no routed tokens is a fully-sparse window,
which the Legion runtime skips (``legion.lowering.lower_moe``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import constrain, local_extent
from repro_torch.models.common import dense_init
from repro_torch.quant.bitnet import EPS, fake_quant_act, fake_quant_weight


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
    # one_hot's comparison form: the same integers, and the same operations
    # on real and fake tensors (the dry run's memory reading)
    onehot = (e_flat[..., None] == torch.arange(
        n_experts_total, device=idx.device)).long()
    cum = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = torch.gather(cum, 2, e_flat[..., None])[..., 0]
    keep = pos_in_e < cap
    return e_flat, torch.where(keep, pos_in_e, cap - 1), keep


def moe_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d].  Capacity-dropped top-k routing."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _moe_block_sharded(p, cfg, x)
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
    # batch stays on the data axes; experts take the model axis (EP)
    buf = constrain(buf, "batch", "experts", None, None)
    if quantize:
        buf = fake_quant_act(buf)
        w1, w2, w3 = (fake_quant_weight(w) for w in (w1, w2, w3))
    h = torch.nn.functional.silu(
        torch.einsum("becd,edf->becf", buf, w1)
    ) * torch.einsum("becd,edf->becf", buf, w3)
    h = constrain(h, "batch", "experts", None, "ff")
    if quantize:
        h = fake_quant_act(h)
    out_buf = torch.einsum("becf,efd->becd", h, w2)
    out_buf = constrain(out_buf, "batch", "experts", None, None)

    # combine: gather each (token, slot)'s result, weight by its gate
    y_slots = out_buf[rows, e_flat, slot_pos]                # [B, S*k, d]
    y_slots = torch.where(keep[..., None], y_slots, 0)
    y = (y_slots.reshape(b, s, k, d).to(torch.float32)
         * gates[..., None]).sum(dim=2)
    return y.to(x.dtype)


def _moe_block_sharded(p, cfg, x):
    """:func:`moe_block` on DTensors, in the JAX package's layout: batch
    rows on the data axes, experts on the model axis (or, where they do
    not divide it, the FFN width).  Each rank routes its rows over their
    whole sequence (the tokens are gathered along it: the capacity
    positions count every token of a row), dispatches the tokens bound for
    its experts into its part of the ``[B, E, cap, d]`` buffer, runs its
    experts' products and combines what they return; the partial outputs
    add up over the expert (or FFN) axes (``Partial``), reduced where the
    caller next needs them.  Fake-quant scales are the whole tensors':
    the weights' absmean over every expert, the activations' absmax over
    the whole FFN width."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    e, k = cfg.n_experts_total, cfg.top_k
    s = x.shape[1]
    cap = int(cfg.capacity_factor * k * s / cfg.n_experts + 1)
    quantize = cfg.quantization == "bitnet"
    xs = x.redistribute(mesh, [Replicate() if pl.is_shard() and pl.dim != 0
                               else pl for pl in x.placements])
    w1, w2, w3 = p["w1"], p["w2"], p["w3"]
    if quantize:
        w1, w2, w3 = (fake_quant_weight(w) for w in (w1, w2, w3))

    def keep(w, dims):
        return w.redistribute(mesh, [pl if pl.is_shard() and pl.dim in dims
                                     else Replicate()
                                     for pl in w.placements])

    # experts (dim 0) or the FFN width stay split; the d axis is gathered
    w1, w3, w2 = keep(w1, (0, 2)), keep(w3, (0, 2)), keep(w2, (0, 1))
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim)
    f_dims = [i for i, pl in enumerate(w1.placements) if pl.is_shard(2)]
    split = [i for i, pl in enumerate(w1.placements) if pl.is_shard()]
    rows_split = [i for i, pl in enumerate(xs.placements) if pl.is_shard(0)]
    (e_local, _, _), (e_lo, _, _) = local_extent(w1)
    f_groups = [mesh.get_group(i) for i in f_dims]

    def fq_act(t):
        if not f_groups:
            return fake_quant_act(t)
        m = torch.amax(torch.abs(t), dim=-1, keepdim=True)
        for grp in f_groups:
            m = funcol.all_reduce(m, "max", grp)
        sc = m / 127.0 + EPS
        tq = torch.clamp(torch.round(t / sc), -128, 127) * sc
        return t + (tq.to(t.dtype) - t).detach()

    def local(xl, rl, w1l, w2l, w3l):
        b, sl, d = xl.shape
        _, gates, idx = route({"router": rl}, cfg, xl)
        e_flat, slot_pos, kept = assign_slots(idx, e, cap)
        mine = kept & (e_flat >= e_lo) & (e_flat < e_lo + e_local)
        le = (e_flat - e_lo).clamp(0, e_local - 1)
        rows = torch.arange(b, device=xl.device)[:, None].expand_as(e_flat)
        x_rep = torch.repeat_interleave(xl, k, dim=1)
        buf = torch.zeros((b, e_local, cap, d), dtype=xl.dtype,
                          device=xl.device)
        buf.index_put_((rows, le, slot_pos),
                       torch.where(mine[..., None], x_rep, 0),
                       accumulate=True)
        if quantize:
            buf = fake_quant_act(buf)
        h = torch.nn.functional.silu(
            torch.einsum("becd,edf->becf", buf, w1l)
        ) * torch.einsum("becd,edf->becf", buf, w3l)
        if quantize:
            h = fq_act(h)
        out_buf = torch.einsum("becf,efd->becd", h, w2l)
        y_slots = out_buf[rows, le, slot_pos]
        y_slots = torch.where(mine[..., None], y_slots, 0)
        y = (y_slots.reshape(b, sl, k, d).to(torch.float32)
             * gates[..., None]).sum(dim=2)
        return y.to(xl.dtype)

    def grad_of(t, shared):
        # a replicated operand used differently by the ranks of an axis
        # gets the sum of their gradients
        return tuple(Partial() if pl == Replicate() and i in shared else pl
                     for i, pl in enumerate(t.placements))

    y_pl = tuple(Partial() if i in split else pl
                 for i, pl in enumerate(xs.placements))
    w_shared = set(rows_split)
    return local_map(
        local, out_placements=(y_pl,),
        in_placements=tuple(t.placements for t in (xs, router, w1, w2, w3)),
        in_grad_placements=(
            grad_of(xs, set(split)), grad_of(router, set(split) | w_shared),
            grad_of(w1, w_shared), grad_of(w2, w_shared),
            grad_of(w3, w_shared)),
        device_mesh=mesh)(xs, router, w1, w2, w3)


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
