"""Causal or full attention forward, softmax(q k^T / sqrt(d)) v, with the
row log-sum-exp written (the training forward)."""


def pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs the function reads: query i sees keys
    0 .. i when causal."""
    if not causal:
        return sq * sk
    full = min(sq, sk)
    return full * (full + 1) // 2 + (sq - full) * sk


def ops(b, h, hkv, sq, sk, d, causal) -> float:
    """s = q k^T and p v over the unmasked pairs."""
    return 4.0 * b * h * pairs(sq, sk, causal) * d


def nbytes(b, h, hkv, sq, sk, d, causal, elt, lse=True) -> float:
    """q, k, v and out once each, and the float32 lse when written."""
    return (float(elt) * d * (2 * b * h * sq + 2 * b * hkv * sk)
            + (4.0 * b * h * sq if lse else 0.0))
