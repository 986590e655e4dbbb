"""Model FLOPs of one training step of the Zamba2-style hybrid (the
``hybrid`` family): Mamba-2 blocks plus one shared attention-and-MLP block
applied before every ``attn_every``-th of them.  One forward and its
backward, 3 x the forward's work: projections and tied head, causal
attention pairs, the SSD scan's own work (B and C shared by the heads), the
depthwise convolution; no recomputation."""

import math

from portbench.cost import flash_fwd, ssd_fwd


def forward_flops(spec: dict, batch: int, seq: int) -> float:
    d, hd = spec["d_model"], spec["head_dim"]
    h, hkv, ff = spec["n_heads"], spec["kv_heads"], spec["d_ff"]
    di = spec["ssm_expand"] * d
    n, p = spec["ssm_state"], spec["ssm_head_dim"]
    nh = di // p
    tokens = batch * seq
    layers = spec["layers"]
    apps = math.ceil(layers / spec["attn_every"])
    mamba = d * (2 * di + 2 * n + nh) + di * d
    shared = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * ff
    proj = 2.0 * tokens * (layers * mamba + apps * shared
                           + d * spec["vocab"])
    attn = apps * flash_fwd.ops(batch, h, hkv, seq, seq, hd, True)
    scan = layers * ssd_fwd.ops(batch, nh, seq, n, p, spec["ssd_chunk"],
                                True)
    conv = layers * 2.0 * tokens * (di + 2 * n) * spec["conv_kernel"]
    return proj + attn + scan + conv


def step_flops(spec: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(spec, batch, seq)
