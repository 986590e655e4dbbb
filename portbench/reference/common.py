"""The plain reference's shared parts: fake-quant with its straight-through
gradient, RMSNorm, RoPE, causal attention, SwiGLU, the tied head and its
loss, AdamW, and the engine that takes a model's loss and gradients layer
by layer.

Plain PyTorch only: nothing here imports the program under test.  Every
operation computes in float32 (float64 in mode ``"float64"``, a witness
of what float32's own rounding moves).  ``Precision`` says where the
stored values are rounded: not at all (``"float32"``, the reference that
decides ``correct``), to bfloat16 (``"bfloat16"``, a diagnostic that
follows the program's stored type), or to fp8 (``"fp8"``, the control:
each stored tensor rounded to float8 e4m3 and each gradient that flows
back through it to e5m2, with one scale a tensor).  The parameters keep the
configuration's stored type in every mode, as the optimizer keeps them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32
EPS_QUANT = 1e-5
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                      57344.0)}


def _fp8(x: torch.Tensor, kind: str) -> torch.Tensor:
    dtype, top = _FP8[kind]
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = top / amax
    return (x * scale).to(dtype).to(F32) / scale


def _round(x: torch.Tensor, mode: str, grad: bool) -> torch.Tensor:
    if mode == "bfloat16":
        return x.to(torch.bfloat16).to(F32)
    return _fp8(x, "e5m2" if grad else "e4m3")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _round(x, mode, False)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode, True), None


@dataclasses.dataclass(frozen=True)
class Precision:
    mode: str = "float32"      # float32 | float64 | bfloat16 | fp8

    @property
    def dtype(self) -> torch.dtype:
        """The type every operation computes in."""
        return torch.float64 if self.mode == "float64" else F32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x as the program stores it (identity in float32 and float64)."""
        if self.mode in ("float32", "float64"):
            return x
        return _Round.apply(x, self.mode)


def configure_matmul() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #

def fake_quant_act(x: torch.Tensor, r: Precision) -> torch.Tensor:
    """BitNet's per-token absmax int8 fake-quant; gradient the identity."""
    s = r(r(x.abs().amax(dim=-1, keepdim=True) / 127.0) + EPS_QUANT)
    q = torch.clamp(torch.round(r(x / s)), -128, 127)
    return x + (r(q * s) - x).detach()


def fake_quant_weight(w: torch.Tensor, r: Precision) -> torch.Tensor:
    """BitNet b1.58's absmean ternary fake-quant; gradient the identity."""
    gamma = r(r(w.abs().mean()) + EPS_QUANT)
    q = torch.clamp(torch.round(r(w / gamma)), -1, 1)
    return w + (r(q * gamma) - w).detach()


def bitlinear(x, w, r: Precision, quant: bool = True):
    """Fake-quantized activations times fake-quantized weights (a plain
    product where the configuration does not quantize)."""
    if quant:
        x, w = fake_quant_act(x, r), fake_quant_weight(w, r)
    return r(x @ w)


def rms_norm(x, gamma, r: Precision, eps: float = 1e-6):
    return r(x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gamma)


def rope(x, theta: float, r: Precision):
    """Rotary embedding of x [B, S, H, D], halves rotated."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=x.dtype, device=x.device) / half)
    ang = torch.arange(s, dtype=x.dtype, device=x.device)[:, None] * freqs
    c, sn = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return r(torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1))


def causal_attention(q, k, v, r: Precision):
    """softmax(q k^T / sqrt(d)) v over keys at or before each query;
    q [B, S, H, D], k / v [B, S, Hkv, D]."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), v)
    return r(out.reshape(b, s, h * d))


def attention_block(p: Dict, x, spec: Dict, r: Precision):
    """Pre-norm causal self-attention with RoPE and BitNet projections,
    then a pre-norm SwiGLU MLP, each added to the residual."""
    b, s, _ = x.shape
    hd, h, hkv = spec["head_dim"], spec["n_heads"], spec["kv_heads"]
    quant = quantized(spec)

    def proj(t, name):
        return bitlinear(t, p[name], r, quant)

    xn = rms_norm(x, p["ln1"], r)
    q = proj(xn, "wq").reshape(b, s, h, hd)
    k = proj(xn, "wk").reshape(b, s, hkv, hd)
    v = proj(xn, "wv").reshape(b, s, hkv, hd)
    theta = spec.get("rope_theta", 10000.0)
    att = causal_attention(rope(q, theta, r), rope(k, theta, r), v, r)
    x = r(x + proj(att, "wo"))
    xn = rms_norm(x, p["ln2"], r)
    hidden = r(r(F.silu(proj(xn, "w1"))) * proj(xn, "w3"))
    return r(x + proj(hidden, "w2"))


def quantized(spec: Dict) -> bool:
    return spec.get("quantization", "bitnet") == "bitnet"


def stored_dtype(spec: Dict) -> torch.dtype:
    return getattr(torch, spec.get("dtype", "bfloat16"))


ATTENTION_LEAVES = {"ln1": ("ln1",), "ln2": ("ln2",),
                    "wq": ("attn", "wq"), "wk": ("attn", "wk"),
                    "wv": ("attn", "wv"), "wo": ("attn", "wo"),
                    "w1": ("mlp", "w1"), "w2": ("mlp", "w2"),
                    "w3": ("mlp", "w3")}


def head_loss(x, embed, ln_f, targets, r: Precision):
    """Mean next-token cross-entropy of the tied head's float32 logits."""
    logits = r(rms_norm(x, ln_f, r) @ r(embed).t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


# --------------------------------------------------------------------------- #
# Parameters: the program's tree layout, made from the seed
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Leaf:
    """One stored parameter: its path in the tree, shape, type and how it
    starts (``("normal", std)`` or ``("const", value)``)."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Tuple[str, float]
    stacked: bool          # leading axis is the layer


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 4099 + index) % (2 ** 63)


def make_leaf(leaf: Leaf, seed: int, index: int, device) -> torch.Tensor:
    kind, value = leaf.init
    if kind == "const":
        return torch.full(leaf.shape, value, dtype=leaf.dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    t = torch.randn(leaf.shape, generator=gen, device=device,
                    dtype=leaf.dtype)
    return t.mul_(value)


def build_tree(leaves: Sequence[Leaf], seed: int, device) -> Dict:
    """Every leaf made on ``device`` from ``seed``: one generator call a
    stacked leaf, in the stored type."""
    tree: Dict = {}
    for i, leaf in enumerate(leaves):
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = make_leaf(leaf, seed, i, device)
    return tree


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def slice_norms(tree, leaves: Sequence[Leaf], fn=None) -> Dict[str, float]:
    """The float32 norm of every parameter slice of ``tree`` (of
    ``fn(leaf_tensor, leaf)`` where given), read back in one transfer."""
    parts, names = [], []
    for leaf in leaves:
        t = get(tree, leaf.path)
        t = fn(t, leaf) if fn is not None else t.to(F32)
        name = ".".join(leaf.path)
        if leaf.stacked:
            parts.append(torch.linalg.vector_norm(
                t.reshape(t.shape[0], -1).to(F32), dim=1))
            names += [f"{name}[{i}]" for i in range(t.shape[0])]
        else:
            parts.append(torch.linalg.vector_norm(t.to(F32)).reshape(1))
            names.append(name)
    values = torch.cat(parts).tolist()
    return dict(zip(names, values))


# --------------------------------------------------------------------------- #
# Loss and gradients, layer by layer
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Unit:
    """One step of the residual stream: ``fn(params, x) -> x`` reading the
    parameters named in ``reads`` (name -> (path, layer or None))."""

    fn: Callable
    reads: Dict[str, Tuple[Tuple[str, ...], object]]


def _take(params, path, layer):
    t = get(params, path)
    return t[layer] if layer is not None else t


def loss_and_grads(units: Sequence[Unit], params, batch, r: Precision):
    """(loss, float32 gradient tree) of the tied-embedding model
    ``units`` on ``batch``: a forward without autograd that keeps each
    unit's input, the head differentiated, then each unit run again with
    autograd from the last to the first, its parameters' gradients added
    into the tree.  One unit's activations are alive at a time."""
    embed, ln_f = params["embed"]["tokens"], params["ln_f"]
    tokens = batch["tokens"].long()
    grads = zeros_like_tree(params)

    dt = r.dtype

    def leaves_of(unit):
        return {name: r(_take(params, path, layer).to(dt))
                for name, (path, layer) in unit.reads.items()}

    inputs = []
    with torch.no_grad():
        x = r(embed.to(dt)[tokens])
        for unit in units:
            inputs.append(x)
            x = unit.fn(leaves_of(unit), x)
    x = x.detach().requires_grad_(True)
    e = embed.detach().to(dt).requires_grad_(True)
    g_ln = ln_f.detach().to(dt).requires_grad_(True)
    loss = head_loss(x, e, g_ln, batch["targets"], r)
    loss.backward()
    grads["embed"]["tokens"] += e.grad
    grads["ln_f"] += g_ln.grad
    g = x.grad
    del x, e, g_ln
    for unit, x_in in zip(reversed(units), reversed(inputs)):
        x_in = x_in.requires_grad_(True)
        raw = {name: _take(params, path, layer).detach().to(dt)
               .requires_grad_(True)
               for name, (path, layer) in unit.reads.items()}
        out = unit.fn({k: r(v) for k, v in raw.items()}, x_in)
        out.backward(g)
        for name, (path, layer) in unit.reads.items():
            target = get(grads, path)
            if layer is not None:
                target = target[layer]
            target += raw[name].grad
        g = x_in.grad
        del out, raw
    inputs.clear()
    grads["embed"]["tokens"].index_add_(
        0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]).to(F32))
    return loss.detach(), grads


# --------------------------------------------------------------------------- #
# AdamW as the configuration states it
# --------------------------------------------------------------------------- #

def zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=F32, device=tree.device)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(g.square().sum() for g in _tensors(grads)))


def adamw_step(params, grads, mu, nu, step: int, opt: Dict,
               leaves: Sequence[Leaf]):
    """One AdamW update in float32, leaf by leaf and in place in the
    trees: gradients clipped to ``clip_norm`` by their global norm,
    bias-corrected moments, weight decay decoupled on every parameter
    stored with two or more axes, the parameters stored back in their own
    type.  Returns the global norm."""
    b1, b2, lr = opt["b1"], opt["b2"], opt["lr"]
    gnorm = global_norm(grads)
    scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for leaf in leaves:
        p, g = get(params, leaf.path), get(grads, leaf.path) * scale
        m, v = get(mu, leaf.path), get(nu, leaf.path)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        if p.ndim >= 2:
            delta += opt["weight_decay"] * p.to(F32)
        get(params, leaf.path[:-1])[leaf.path[-1]] = (
            p.to(F32) - lr * delta).to(p.dtype)
    return gnorm
