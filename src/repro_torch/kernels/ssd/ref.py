"""Plain PyTorch versions of the SSD scan kernel.

``ssd_scan_ref``      — the exact per-timestep recurrence (ground truth;
                        O(S) sequential).
``ssd_chunked_ref``   — the chunked SSD, the kernel's own math vectorised
                        over chunks, with the chunk-to-chunk state carry as a
                        loop.
``ssd_grouped_scan``  — the JAX model's default scan: chunk after chunk,
                        one ``[B, H, q, q]`` tile live, C Bᵀ once per batch
                        for the head-shared B and C.
``ssd_chunked_bwd_ref`` — the chunked scan's gradient in closed form, in
                        three steps: the state gradients, the products
                        in a chunk, the log decay's gradient (the
                        backward kernels, ``csrc/ssd_bwd.cu``, compute the
                        same gradient).

Inputs are pre-scaled (``dta = dt * A`` [negative], ``dtx = dt * x``) and
computed in float32; see ``csrc/ssd.cu`` for the recurrence.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_scan_ref(
    dta: torch.Tensor,     # [BH, S]
    dtx: torch.Tensor,     # [BH, S, P]
    b: torch.Tensor,       # [BH, S, N]
    c: torch.Tensor,       # [BH, S, N]
    *,
    return_state: bool = False,
):
    """h_t = exp(dta_t) h_{t-1} + B_t (dtx_t)^T ;  y_t = C_t^T h_t."""
    bh, s, p = dtx.shape
    n = b.shape[-1]
    f32 = torch.float32
    dta, dtx, b, c = (t.to(f32) for t in (dta, dtx, b, c))
    h = torch.zeros((bh, n, p), dtype=f32, device=dtx.device)
    ys = []
    for t in range(s):
        h = torch.exp(dta[:, t])[:, None, None] * h + torch.einsum(
            "bn,bp->bnp", b[:, t], dtx[:, t])
        ys.append(torch.einsum("bn,bnp->bp", c[:, t], h))
    y = torch.stack(ys, dim=1) if ys else dtx.new_zeros((bh, 0, p))
    return (y, h) if return_state else y


def ssd_chunked_ref(
    dta: torch.Tensor,     # [BH, S]
    dtx: torch.Tensor,     # [BH, S, P]
    b: torch.Tensor,       # [BH, S, N]
    c: torch.Tensor,       # [BH, S, N]
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """Chunked SSD — the kernel's math in plain tensor operations.

    ``S`` must be a multiple of ``chunk`` (as in the JAX package)."""
    bh, s, p = dtx.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} not divisible by chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32
    dta_c = dta.reshape(bh, nc, chunk).to(f32)
    dtx_c = dtx.reshape(bh, nc, chunk, p).to(f32)
    b_c = b.reshape(bh, nc, chunk, n).to(f32)
    c_c = c.reshape(bh, nc, chunk, n).to(f32)

    la = torch.cumsum(dta_c, dim=-1)                      # [bh, nc, q]
    idx = torch.arange(chunk, device=dtx.device)
    lower = idx[:, None] >= idx[None, :]
    seg = torch.where(lower, la[..., :, None] - la[..., None, :],
                      torch.tensor(-1e30, dtype=f32, device=dtx.device))
    decay = torch.exp(seg)                                # [bh, nc, q, q]
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c) * decay
    y = torch.einsum("bcij,bcjp->bcip", scores, dtx_c)

    # inter-chunk state recurrence over chunks
    la_tot = la[..., -1]                                  # [bh, nc]
    decay_out = torch.exp(la_tot[..., None] - la)         # [bh, nc, q]
    chunk_state = torch.einsum(                           # [bh, nc, n, p]
        "bcjn,bcjp->bcnp", b_c * decay_out[..., None], dtx_c)
    h = torch.zeros((bh, n, p), dtype=f32, device=dtx.device)
    y_inter = []
    for k in range(nc):
        y_inter.append(torch.einsum(
            "bin,bnp->bip", c_c[:, k] * torch.exp(la[:, k])[..., None], h))
        h = torch.exp(la_tot[:, k])[:, None, None] * h + chunk_state[:, k]
    y = y + torch.stack(y_inter, dim=1)
    y = y.reshape(bh, s, p).to(dtx.dtype)
    return (y, h) if return_state else y


def ssd_grouped_scan(
    dta: torch.Tensor,     # [B, H, S]
    dtx: torch.Tensor,     # [B, H, S, P]
    b: torch.Tensor,       # [B, S, N]   group-shared (Mamba-2 n_groups=1)
    c: torch.Tensor,       # [B, S, N]
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """Production-memory chunked SSD: a sequential loop over chunks (one
    ``[B, H, q, q]`` tile live at a time, where :func:`ssd_chunked_ref`
    holds all of them) with **group-shared scores**: C_i B_j^T is computed
    once per batch, not once per head, since Mamba-2's heads share B and C.
    Differentiable, in plain tensor operations (DTensors included).

    ``S`` must be a multiple of ``chunk``.  Returns y ``[B, H, S, P]`` in
    dtx's type (and the final state ``[B, H, N, P]`` float32)."""
    bsz, h, s, p = dtx.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} not divisible by chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32
    dta_c = dta.reshape(bsz, h, nc, chunk).to(f32)
    dtx_c = dtx.reshape(bsz, h, nc, chunk, p).to(f32)
    b_c = b.reshape(bsz, nc, chunk, n).to(f32)
    c_c = c.reshape(bsz, nc, chunk, n).to(f32)
    idx = torch.arange(chunk, device=dtx.device)
    upper = idx[:, None] < idx[None, :]

    hst = torch.zeros((bsz, h, n, p), dtype=f32, device=dtx.device)
    ys = []
    for k in range(nc):
        dta_k, dtx_k = dta_c[:, :, k], dtx_c[:, :, k]   # [B,H,q], [B,H,q,p]
        b_k, c_k = b_c[:, k], c_c[:, k]                  # [B,q,n] each
        la = torch.cumsum(dta_k, dim=-1)                 # [B,H,q]
        seg = (la[..., :, None] - la[..., None, :]).masked_fill(upper, -1e30)
        decay = torch.exp(seg)                           # [B,H,q,q]
        group_scores = torch.einsum("bin,bjn->bij", c_k, b_k)   # once per B
        y = torch.einsum("bhij,bhjp->bhip", group_scores[:, None] * decay,
                         dtx_k)
        la_tot = la[..., -1]                             # [B,H]
        # inter-chunk state readout: (C_i * exp(la_i)) @ h_prev
        y = y + torch.einsum("bhin,bhnp->bhip",
                             c_k[:, None] * torch.exp(la)[..., None], hst)
        decay_out = torch.exp(la_tot[..., None] - la)    # [B,H,q]
        hst = torch.exp(la_tot)[..., None, None] * hst + torch.einsum(
            "bhjn,bhjp->bhnp", b_k[:, None] * decay_out[..., None], dtx_k)
        ys.append(y.to(dtx.dtype))
    y = torch.stack(ys, dim=2).reshape(bsz, h, s, p)
    return (y, hst) if return_state else y


def ssd_chunked_bwd_ref(
    dta: torch.Tensor,     # [BH, S]
    dtx: torch.Tensor,     # [BH, S, P]
    b: torch.Tensor,       # [BH, S, N]
    c: torch.Tensor,       # [BH, S, N]
    dy: torch.Tensor,      # [BH, S, P]
    *,
    chunk: int = 128,
    dh_final: Optional[torch.Tensor] = None,   # [BH, N, P]
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`ssd_chunked_ref` (y and, through
    ``dh_final``, the terminal state) with respect to dta, dtx, b and c,
    in closed form: no autograd.  ``S`` need not be a multiple of
    ``chunk``: the last chunk is shorter, as in the kernel (padding with
    dta = 0 and zero inputs and gradients changes nothing).

    Per chunk of q steps, with la = cumsum(dta) inside it, A = la_q, H_in
    the state entering it, s its own state and G the gradient of the state
    leaving it (``dh_final`` for the last chunk):

    1. u = (C * exp(la))^T dy, and the reverse pass over the chunks
       G_in = exp(A) G + u;
    2. dx_j = sum_{i>=j} (C_i.B_j) exp(la_i - la_j) dy_i
              + exp(A - la_j) G^T B_j,
       dC_i = sum_{j<=i} (dy_i.x_j) exp(la_i - la_j) B_j + exp(la_i) H_in dy_i,
       dB_j = sum_{i>=j} (dy_i.x_j) exp(la_i - la_j) C_i + exp(A - la_j) G x_j;
    3. d la_k = C_k.dC_k - x_k.dx_k (the intra-chunk row and column sums,
       the state readout and the chunk state's own decays), plus
       <G, exp(A) H_in + s> at the chunk's last step (A's two terms), and
       ddta is its reverse cumulative sum inside the chunk.

    Every exponent is <= 0 for negative dta, as in the forward.  Every
    product goes through ``matmul`` (batched ``a @ b``), so that a test can
    put the kernel's arithmetic in its place."""
    bh, s, p = dtx.shape
    n = b.shape[-1]
    f32 = torch.float32
    pad = (-s) % chunk
    if pad:
        dta = F.pad(dta, (0, pad))
        dtx, b, c, dy = (F.pad(t, (0, 0, 0, pad)) for t in (dtx, b, c, dy))
    nc = (s + pad) // chunk
    dta_c = dta.reshape(bh, nc, chunk).to(f32)
    x = dtx.reshape(bh, nc, chunk, p).to(f32)
    b_c = b.reshape(bh, nc, chunk, n).to(f32)
    c_c = c.reshape(bh, nc, chunk, n).to(f32)
    g_y = dy.reshape(bh, nc, chunk, p).to(f32)

    la = torch.cumsum(dta_c, dim=-1)                      # [bh, nc, q]
    a_tot = la[..., -1]                                   # [bh, nc]
    idx = torch.arange(chunk, device=dtx.device)
    lower = idx[:, None] >= idx[None, :]
    decay = torch.where(lower, torch.exp(torch.where(
        lower, la[..., :, None] - la[..., None, :], 0.0)), 0.0)
    w_in = torch.exp(la)                                  # exp(la_i)
    w_out = torch.exp(a_tot[..., None] - la)              # exp(A - la_j)

    # the forward's chunk states and the states entering each chunk
    mT = lambda t: t.transpose(-1, -2)                    # noqa: E731
    own = matmul(mT(b_c * w_out[..., None]), x)
    h = torch.zeros((bh, n, p), dtype=f32, device=dtx.device)
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = torch.exp(a_tot[:, k])[:, None, None] * h + own[:, k]
    h_in = torch.stack(h_in, dim=1)                       # [bh, nc, n, p]
    h_out = torch.cat([h_in[:, 1:], h[:, None]], dim=1)

    # 1. the state gradients, last chunk first
    u = matmul(mT(c_c * w_in[..., None]), g_y)
    g = (torch.zeros((bh, n, p), dtype=f32, device=dtx.device)
         if dh_final is None else dh_final.to(f32))
    g_out = [None] * nc
    for k in reversed(range(nc)):
        g_out[k] = g
        g = torch.exp(a_tot[:, k])[:, None, None] * g + u[:, k]
    g_out = torch.stack(g_out, dim=1)                     # [bh, nc, n, p]

    # 2. the intra-chunk products and the state terms
    scores = matmul(c_c, mT(b_c)) * decay
    dyx = matmul(g_y, mT(x)) * decay
    ddtx = (matmul(mT(scores), g_y)
            + w_out[..., None] * matmul(b_c, g_out))
    dc = (matmul(dyx, b_c) + w_in[..., None] * matmul(g_y, mT(h_in)))
    db = (matmul(mT(dyx), c_c) + w_out[..., None] * matmul(x, mT(g_out)))

    # 3. the log-decay gradient and its reverse cumulative sum
    dla = (c_c * dc).sum(-1) - (x * ddtx).sum(-1)
    dla[..., -1] += (g_out * h_out).sum((-2, -1))
    ddta = torch.flip(torch.cumsum(torch.flip(dla, (-1,)), -1), (-1,))

    def back(t, *tail):
        return t.reshape(bh, s + pad, *tail)[:, :s]

    return (back(ddta), back(ddtx, p).to(dtx.dtype), back(db, n),
            back(dc, n))
