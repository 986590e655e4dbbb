"""The SSD scan's backward: ddta, ddtx, dB, dC from dta, dtx, B, C
and dy (float32)."""


def work(s: int, n: int, p: int, chunk: int):
    """(multiply-adds a copy of B and C, multiply-adds a head).  A copy of
    B and C: the causal halves of C B^T and of the masked tile's products
    with B and C (dC, dB), which act on the heads' sum of that tile where
    the heads share B and C.  A head: the causal halves of dy x^T and of
    (C B^T o L)^T dy, and four N x P products a chunk."""
    per_copy = per_head = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        tri = q * (q + 1) // 2
        per_copy += 3 * tri * n
        per_head += 2 * tri * p + 4 * q * n * p
    return per_copy, per_head


def ops(nb, nh, s, n, p, chunk, shared_bc) -> float:
    copies = nb if shared_bc else nb * nh
    per_copy, per_head = work(s, n, p, chunk)
    return 2.0 * (copies * per_copy + nb * nh * per_head)


def nbytes(nb, nh, s, n, p, shared_bc, dh_final=False) -> float:
    """dta, dtx, B, C, dy read once; ddta, ddtx, dB, dC written once; the
    terminal state's gradient read where it is given."""
    copies = nb if shared_bc else nb * nh
    return 4.0 * (2 * nb * nh * s + 3 * nb * nh * s * p + 4 * copies * s * n
                  + (nb * nh * n * p if dh_final else 0))
