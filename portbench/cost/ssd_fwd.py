"""Mamba-2's chunked SSD scan, forward: h_t = exp(dta_t) h_{t-1} +
B_t dtx_t^T, y_t = C_t^T h_t, over float32 inputs dta [B, H, S],
dtx [B, H, S, P] and B, C [B, S, N] shared by the heads (Mamba-2's single
group) or [B, H, S, N]."""


def work(s: int, n: int, p: int, chunk: int):
    """(multiply-adds a copy of B and C, multiply-adds a head) over the
    chunks: the causal half of each chunk's C B^T tile; per head its
    product with dtx, the state readout and the state update."""
    per_copy = per_head = 0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        tri = q * (q + 1) // 2
        per_copy += tri * n
        per_head += tri * p + 2 * q * n * p
    return per_copy, per_head


def ops(nb, nh, s, n, p, chunk, shared_bc) -> float:
    """The C B^T tile once a batch where the heads share B and C."""
    copies = nb if shared_bc else nb * nh
    per_copy, per_head = work(s, n, p, chunk)
    return 2.0 * (copies * per_copy + nb * nh * per_head)


def nbytes(nb, nh, s, n, p, shared_bc, state=False) -> float:
    """dta, dtx, B, C read and y written once (float32), and the terminal
    state where it is returned."""
    copies = nb if shared_bc else nb * nh
    return 4.0 * (nb * nh * s + 2 * nb * nh * s * p + 2 * copies * s * n
                  + (nb * nh * n * p if state else 0))
