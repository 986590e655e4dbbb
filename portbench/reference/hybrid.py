"""Reference of the ``hybrid`` family (Zamba2-style): Mamba-2 blocks, with
one shared attention-and-SwiGLU block (one set of weights) applied before
block 0 and every ``attn_every``-th block after it, and a tied
embedding."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    ATTENTION_LEAVES, F32, Leaf, Unit, attention_block, bitlinear,
    quantized, rms_norm, stored_dtype,
)


def dims(spec: Dict):
    di = spec["ssm_expand"] * spec["d_model"]
    p = spec["ssm_head_dim"]
    return di, di // p, spec["ssm_state"], p


def leaves(spec: Dict) -> List[Leaf]:
    dt = stored_dtype(spec)
    L, d, ff, v = spec["layers"], spec["d_model"], spec["d_ff"], spec["vocab"]
    di, nh, n, _ = dims(spec)
    cd, k = di + 2 * n, spec["conv_kernel"]
    inner = spec["n_heads"] * spec["head_dim"]
    kv = spec["kv_heads"] * spec["head_dim"]
    one, zero = ("const", 1.0), ("const", 0.0)
    normal = lambda d_in: ("normal", 1.0 / math.sqrt(d_in))  # noqa: E731
    ssm = ("blocks", "ssm")
    return [
        Leaf(("embed", "tokens"), (v, d), dt, ("normal", 0.02), False),
        Leaf(("blocks", "ln"), (L, d), dt, one, True),
        Leaf(ssm + ("in_proj_z",), (L, d, di), dt, normal(d), True),
        Leaf(ssm + ("in_proj_xbc",), (L, d, cd), dt, normal(d), True),
        Leaf(ssm + ("in_proj_dt",), (L, d, nh), dt, normal(d), True),
        Leaf(ssm + ("out_proj",), (L, di, d), dt, normal(di), True),
        Leaf(ssm + ("conv_w",), (L, k, cd), dt, ("normal", 0.1), True),
        Leaf(ssm + ("conv_b",), (L, cd), dt, zero, True),
        Leaf(ssm + ("a_log",), (L, nh), F32, zero, True),
        Leaf(ssm + ("dt_bias",), (L, nh), F32, ("const", -2.0), True),
        Leaf(ssm + ("d_skip",), (L, nh), F32, one, True),
        Leaf(ssm + ("norm",), (L, di), dt, one, True),
        Leaf(("shared", "ln1"), (d,), dt, one, False),
        Leaf(("shared", "attn", "wq"), (d, inner), dt, normal(d), False),
        Leaf(("shared", "attn", "wk"), (d, kv), dt, normal(d), False),
        Leaf(("shared", "attn", "wv"), (d, kv), dt, normal(d), False),
        Leaf(("shared", "attn", "wo"), (inner, d), dt, normal(inner), False),
        Leaf(("shared", "ln2"), (d,), dt, one, False),
        Leaf(("shared", "mlp", "w1"), (d, ff), dt, normal(d), False),
        Leaf(("shared", "mlp", "w2"), (ff, d), dt, normal(ff), False),
        Leaf(("shared", "mlp", "w3"), (d, ff), dt, normal(d), False),
        Leaf(("ln_f",), (d,), dt, one, False),
    ]


def ssd(dta, dtx, b, c, chunk: int):
    """The state-space scan h_t = exp(dta_t) h_{t-1} + B_t dtx_t^T,
    y_t = C_t^T h_t, chunk by chunk: dta [B, H, S], dtx [B, H, S, P],
    B and C [B, S, N] shared by the heads -> y [B, H, S, P]."""
    nb, nh, s, p = dtx.shape
    n = b.shape[-1]
    nc = s // chunk
    la = dta.reshape(nb, nh, nc, chunk).cumsum(-1)
    x = dtx.reshape(nb, nh, nc, chunk, p)
    bc = b.reshape(nb, nc, chunk, n)
    cc = c.reshape(nb, nc, chunk, n)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=dtx.device).tril()
    seg = la[..., :, None] - la[..., None, :]
    decay = torch.exp(torch.where(lower, seg, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bhcij,bhcjp->bhcip", cb[:, None] * decay, x)
    last = la[..., -1]
    states = torch.einsum("bhcj,bcjn,bhcjp->bhcnp",
                          torch.exp(last[..., None] - la), bc, x)
    h = torch.zeros(nb, nh, n, p, dtype=dtx.dtype, device=dtx.device)
    inter = []
    for k in range(nc):
        inter.append(torch.einsum("bin,bhnp->bhip", cc[:, k], h)
                     * torch.exp(la[:, :, k])[..., None])
        h = torch.exp(last[:, :, k])[..., None, None] * h + states[:, :, k]
    y = y + torch.stack(inter, dim=2)
    return y.reshape(nb, nh, s, p)


def mamba_block(p, x, spec: Dict, r):
    """x + the Mamba-2 mixer of rms_norm(x): BitNet in-projections to z,
    x B C and dt; a causal depthwise convolution and SiLU over x B C; the
    SSD scan with the D skip; a gated RMSNorm; the BitNet out-projection."""
    nb, s, _ = x.shape
    di, nh, n, hd = dims(spec)
    quant = quantized(spec)
    h = rms_norm(x, p["ln"], r)
    z = bitlinear(h, p["in_proj_z"], r, quant)
    xbc = bitlinear(h, p["in_proj_xbc"], r, quant)
    dt = F.softplus(bitlinear(h, p["in_proj_dt"], r, quant) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    k = p["conv_w"].shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv = r(pad[:, :s] * p["conv_w"][0])
    for i in range(1, k):
        conv = r(conv + r(pad[:, i:i + s] * p["conv_w"][i]))
    xbc = r(F.silu(r(conv + p["conv_b"])))
    xh = xbc[..., :di].reshape(nb, s, nh, hd)
    bmat, cmat = xbc[..., di:di + n], xbc[..., di + n:]
    y = ssd((dt * a).transpose(1, 2), (xh * dt[..., None]).transpose(1, 2),
            bmat, cmat, min(spec["ssd_chunk"], s))
    y = y.transpose(1, 2) + xh * p["d_skip"][:, None]
    y = r(rms_norm(r(y.reshape(nb, s, di)), p["norm"], r)
          * r(F.silu(z)))
    return r(x + bitlinear(y, p["out_proj"], r, quant))


MAMBA_LEAVES = {"ln": ("ln",)} | {
    name: ("ssm", name) for name in (
        "in_proj_z", "in_proj_xbc", "in_proj_dt", "out_proj", "conv_w",
        "conv_b", "a_log", "dt_bias", "d_skip", "norm")}


def units(spec: Dict, r) -> List[Unit]:
    shared = Unit(lambda p, x: attention_block(p, x, spec, r),
                  {name: (("shared",) + path, None)
                   for name, path in ATTENTION_LEAVES.items()})
    every = spec["attn_every"]
    out = []
    for i in range(spec["layers"]):
        if i % every == 0:
            out.append(shared)
        out.append(Unit(lambda p, x: mamba_block(p, x, spec, r),
                        {name: (("blocks",) + path, i)
                         for name, path in MAMBA_LEAVES.items()}))
    return out
