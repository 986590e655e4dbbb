"""Attention backward: dq, dk, dv from q, k, v, out, dout and the lse."""

from portbench.cost.flash_fwd import pairs


def ops(b, h, hkv, sq, sk, d, causal) -> float:
    """The five products over the unmasked pairs: s = q k^T, dv = p^T do,
    dp = do v^T, dq = ds k, dk = ds^T q."""
    return 10.0 * b * h * pairs(sq, sk, causal) * d


def nbytes(b, h, hkv, sq, sk, d, causal, elt) -> float:
    """q, out, dout, k, v and the float32 lse read once; dq, dk, dv
    written once."""
    return (float(elt) * d * (4 * b * h * sq + 4 * b * hkv * sk)
            + 4.0 * b * h * sq)
