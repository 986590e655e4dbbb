"""Reference of the ``dense`` family: a pre-norm decoder of BitNet
attention-and-SwiGLU blocks with a tied embedding (BitNet-1.58B)."""
from __future__ import annotations

import math
from typing import Dict, List

from portbench.reference.common import (
    ATTENTION_LEAVES, Leaf, Unit, attention_block, stored_dtype,
)


def _normal(d_in: int):
    return ("normal", 1.0 / math.sqrt(d_in))


def leaves(spec: Dict) -> List[Leaf]:
    """The stored parameters in the program's tree layout, each layer's
    leaves stacked on a leading axis."""
    dt = stored_dtype(spec)
    L, d, ff, v = spec["layers"], spec["d_model"], spec["d_ff"], spec["vocab"]
    inner = spec["n_heads"] * spec["head_dim"]
    kv = spec["kv_heads"] * spec["head_dim"]
    one = ("const", 1.0)
    return [
        Leaf(("embed", "tokens"), (v, d), dt, ("normal", 0.02), False),
        Leaf(("blocks", "ln1"), (L, d), dt, one, True),
        Leaf(("blocks", "ln2"), (L, d), dt, one, True),
        Leaf(("blocks", "attn", "wq"), (L, d, inner), dt, _normal(d), True),
        Leaf(("blocks", "attn", "wk"), (L, d, kv), dt, _normal(d), True),
        Leaf(("blocks", "attn", "wv"), (L, d, kv), dt, _normal(d), True),
        Leaf(("blocks", "attn", "wo"), (L, inner, d), dt, _normal(inner),
             True),
        Leaf(("blocks", "mlp", "w1"), (L, d, ff), dt, _normal(d), True),
        Leaf(("blocks", "mlp", "w2"), (L, ff, d), dt, _normal(ff), True),
        Leaf(("blocks", "mlp", "w3"), (L, d, ff), dt, _normal(d), True),
        Leaf(("ln_f",), (d,), dt, one, False),
    ]


def units(spec: Dict, r) -> List[Unit]:
    def block(p, x):
        return attention_block(p, x, spec, r)

    return [Unit(block, {name: (("blocks",) + path, i)
                         for name, path in ATTENTION_LEAVES.items()})
            for i in range(spec["layers"])]
