"""Model FLOPs of one training step of a dense decoder (the ``dense``
family): one forward and its backward, 3 x the forward's products,
counted from the configuration's shapes.  No recomputation is counted."""

from portbench.cost import flash_fwd


def forward_flops(spec: dict, batch: int, seq: int) -> float:
    d, hd = spec["d_model"], spec["head_dim"]
    h, hkv, ff = spec["n_heads"], spec["kv_heads"], spec["d_ff"]
    tokens = batch * seq
    per_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * ff
    proj = 2.0 * tokens * (spec["layers"] * per_layer + d * spec["vocab"])
    attn = spec["layers"] * flash_fwd.ops(batch, h, hkv, seq, seq, hd,
                                          spec.get("causal", True))
    return proj + attn


def step_flops(spec: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(spec, batch, seq)
