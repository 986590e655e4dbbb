"""Token-choice top-k MoE — the port so far holds its workload-zoo view
only; the model itself waits for its slice (ROADMAP.md, Queue 1).

The ZTB analogy: an expert with no routed tokens is a fully-sparse window,
which the Legion runtime skips (``legion.lowering.lower_moe``).
"""
from __future__ import annotations


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
