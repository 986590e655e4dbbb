"""What the hand-written kernels cost: their operations and bytes, and the
least time an H100 could take for the same work.

Two readers share these formulas: ``chip_smoke.py``, which puts each
kernel's measured time beside its bound (``flash_bound``,
``flash_bwd_bound``, ``ssd_bound``, ``ssd_bwd_bound``), and the ATen-level
cost counter of the dry run (``repro_torch.launch.hlo_cost``), which
charges a kernel launch by its byte formula and, through
``torch.utils.flop_counter``, by its FLOP formula (registered in the
kernels' ``ops`` modules).

The bounds count the work the function needs (the five products of the
attention backward, a causal score tile's lower half, each input read once
and each output written once).  The FLOP formulas count what the kernels
issue, which is more: the bf16 flash forward multiplies P by V in two
bf16 terms, the backward recomputes s and dp, and the SSD scan computes
its score tile per head, and the SSD backward its C B^T and its dB and dC
products once a head group where the heads share B and C (the bound: once
a batch).

Rates are the H100 SXM data sheet's (dense tensor-core peaks).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3
BF16_OPS_PER_S = 989e12        # dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12       # dense int8 tensor cores
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # dense TF32 tensor cores
# float32 products as three TF32 ones (hi.hi, hi.lo, lo.hi: 3xTF32)
TF32X3_OPS_PER_S = TF32_OPS_PER_S / 3


def _bound(nbytes: float, ops: float, op_rate: float):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / op_rate * 1e3
    return max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else "operations"


# --------------------------------------------------------------------------- #
# Flash attention
# --------------------------------------------------------------------------- #

def pairs(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """The (query, key) pairs a causal call sees, query i at q_offset + i."""
    if not causal:
        return sq * sk
    # sum over i < sq of min(q_offset + i + 1, sk), in closed form
    full = max(0, min(sq, sk - q_offset))        # rows below the clip
    first = q_offset + 1
    return (full * (2 * first + full - 1)) // 2 + (sq - full) * sk


def keys_read(sq: int, sk: int, causal: bool, q_offset: int = 0) -> int:
    """The keys a call must read: a causal call whose last query sits at
    q_offset + sq - 1 reaches only the first min(sk, q_offset + sq)."""
    return min(sk, q_offset + sq) if causal else sk


def flash_bytes(b, h, hkv, sq, sk, d, causal, elt, q_offset=0) -> float:
    """q, the keys and values the call reaches, and o, once each."""
    reach = keys_read(sq, sk, causal, q_offset)
    return float(elt) * d * (2 * b * h * sq + 2 * b * hkv * reach)


def flash_bound(b, h, hkv, sq, sk, d, causal, elt, q_offset=0):
    """(bound ms, "bytes" | "operations"): :func:`flash_bytes` over HBM
    against the two products over the unmasked (query, key) pairs at the
    type's peak (bf16 tensor cores, float32 CUDA cores)."""
    ops = 4.0 * b * h * pairs(sq, sk, causal, q_offset) * d
    return _bound(flash_bytes(b, h, hkv, sq, sk, d, causal, elt, q_offset),
                  ops, BF16_OPS_PER_S if elt == 2 else F32_OPS_PER_S)


def flash_flops(b, h, sq, sk, d, causal, elt, q_offset=0) -> float:
    """What the forward kernel issues: s = q k^T and P V over the unmasked
    pairs, P V twice in bf16 (P = P_hi + P_lo, ``csrc/flash_attention.cu``)."""
    products = 3 if elt == 2 else 2
    return 2.0 * products * b * h * pairs(sq, sk, causal, q_offset) * d


def flash_bwd_bytes(b, h, hkv, sq, sk, d, causal, elt, q_offset=0) -> float:
    """q, out, dout, the lse and the keys and values the call reaches read
    once, dq, dk and dv (every key's) written once."""
    reach = keys_read(sq, sk, causal, q_offset)
    return (float(elt) * d * (4 * b * h * sq + 2 * b * hkv * (reach + sk))
            + 4.0 * b * h * sq)


def flash_bwd_bound(b, h, hkv, sq, sk, d, causal, elt, q_offset=0):
    """(bound ms, "bytes" | "operations") of the attention backward:
    :func:`flash_bwd_bytes` over HBM against its five products (s = q k^T,
    dv, dp, dq, dk) over the unmasked (query, key) pairs at the type's
    peak."""
    ops = 10.0 * b * h * pairs(sq, sk, causal, q_offset) * d
    return _bound(flash_bwd_bytes(b, h, hkv, sq, sk, d, causal, elt,
                                  q_offset),
                  ops, BF16_OPS_PER_S if elt == 2 else F32_OPS_PER_S)


def flash_bwd_flops(b, h, sq, sk, d, causal, elt, q_offset=0) -> float:
    """What the three backward kernels issue (``csrc/flash_attention_bwd.cu``):
    the dk / dv kernel recomputes s and dp beside dv and dk, the dq kernel
    recomputes s and dp beside dq (seven products in float32); in bf16, ds
    enters dk and dq as two terms, and above d = 64 the dk / dv kernel runs
    a second pass that recomputes s (nine products, ten above d = 64); and
    the rows' dot D = rowsum(dout * out)."""
    if elt == 2:
        products = 10 if d > 64 else 9
    else:
        products = 7
    return (2.0 * products * b * h * pairs(sq, sk, causal, q_offset) * d
            + 2.0 * b * h * sq * d)


# --------------------------------------------------------------------------- #
# SSD scan
# --------------------------------------------------------------------------- #

def _ssd_work(s: int, n: int, p: int, chunk: int):
    """(score-tile multiply-adds, per-head multiply-adds) over the chunks:
    the causal half of each q x q tile C B^T, its product with dtx, the
    state readout and the state update."""
    scores = per_head = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        scores += q * (q + 1) // 2 * n
        per_head += q * (q + 1) // 2 * p + 2 * q * n * p
    return scores, per_head


def ssd_bytes(nb, nh, s, n, p, shared_bc) -> float:
    """dta, dtx, B, C, y and the terminal state, once each (B and C once
    per batch where the heads share them)."""
    bc_copies = nb if shared_bc else nb * nh
    return 4.0 * (nb * nh * s + 2 * nb * nh * s * p + 2 * bc_copies * s * n
                  + nb * nh * n * p)


def ssd_bound(nb, nh, s, n, p, chunk, shared_bc):
    """(bound ms, "bytes" | "operations"): :func:`ssd_bytes` over HBM
    against the chunked algorithm's float32 multiply-adds at the float32
    peak; where B and C are shared by the heads (``shared_bc``) their
    score tile is computed once per batch."""
    bc_copies = nb if shared_bc else nb * nh
    scores, per_head = _ssd_work(s, n, p, chunk)
    ops = 2.0 * (bc_copies * scores + nb * nh * per_head)
    return _bound(ssd_bytes(nb, nh, s, n, p, shared_bc), ops, F32_OPS_PER_S)


def ssd_flops(nb, nh, s, n, p, chunk) -> float:
    """What the scan kernel issues: the score tile per head (``csrc/ssd.cu``
    shares it across heads only in its reads)."""
    scores, per_head = _ssd_work(s, n, p, chunk)
    return 2.0 * nb * nh * (scores + per_head)


def _ssd_bwd_work(s: int, n: int, p: int, chunk: int):
    """(multiply-adds a copy of B and C, per-head multiply-adds) of the
    backward over the chunks.  A copy of B and C: the causal halves of
    C B^T and of the masked tile's two products with B and C (dC and dB),
    which act on the heads' sum of that tile where the heads share B and C
    (they are linear in it).  Per head: the causal halves of dy x^T and of
    (C B^T o L)^T dy (dx), and four N x P products a chunk (u_c, the state
    terms of dx and dB, the readout term of dC)."""
    per_copy = per_head = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        tri = q * (q + 1) // 2
        per_copy += 3 * tri * n
        per_head += 2 * tri * p + 4 * q * n * p
    return per_copy, per_head


def ssd_bwd_bytes(nb, nh, s, n, p, shared_bc, dh_final=False) -> float:
    """dta, dtx, B, C and dy read once, ddta, ddtx, dB and dC written once
    (B, C, dB and dC once per batch where the heads share them), and the
    terminal state's gradient read where it is given."""
    bc_copies = nb if shared_bc else nb * nh
    return 4.0 * (2 * nb * nh * s + 3 * nb * nh * s * p
                  + 4 * bc_copies * s * n
                  + (nb * nh * n * p if dh_final else 0))


def ssd_bwd_ops(nb, nh, s, n, p, chunk, shared_bc) -> float:
    """The least operations the SSD backward needs (:func:`_ssd_bwd_work`,
    one copy of B and C per batch where the heads share them), each
    product counted once."""
    bc_copies = nb if shared_bc else nb * nh
    per_copy, per_head = _ssd_bwd_work(s, n, p, chunk)
    return 2.0 * (bc_copies * per_copy + nb * nh * per_head)


def ssd_bwd_bound(nb, nh, s, n, p, chunk, shared_bc, dh_final=False,
                  op_rate=TF32X3_OPS_PER_S):
    """(bound ms, "bytes" | "operations") of the SSD backward:
    :func:`ssd_bwd_bytes` over HBM against :func:`ssd_bwd_ops` at
    ``op_rate``: by default the rate of the kernels' path, float32 products
    as three TF32 ones on the tensor cores; ``F32_OPS_PER_S`` gives the
    float32 CUDA-core bound."""
    return _bound(ssd_bwd_bytes(nb, nh, s, n, p, shared_bc, dh_final),
                  ssd_bwd_ops(nb, nh, s, n, p, chunk, shared_bc), op_rate)


def ssd_bwd_flops(nb, nh, s, n, p, chunk, group=1) -> float:
    """What the backward kernels issue (``csrc/ssd_bwd.cu``), each product
    counted once (the tensor cores take it three times, as 3xTF32): per
    group of ``group`` heads sharing B and C, the causal halves of C B^T
    and of the head-summed masked tile's two products with B and C (dC and
    dB); per head the causal halves of dy x^T and of (C B^T o L)^T dy, and
    five N x P products a chunk (u_c, C H_in, B G, dy H_in^T, x G^T).
    ``group`` 1 where each head has its own B and C.  The reverse pass and
    the sum of the groups' partials (under 1 %) are not counted."""
    per_group = per_head = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        tri = q * (q + 1) // 2
        per_group += 3 * tri * n
        per_head += 2 * tri * p + 5 * q * n * p
    groups = -(-nh // group)
    return 2.0 * nb * (groups * per_group + nh * per_head)
