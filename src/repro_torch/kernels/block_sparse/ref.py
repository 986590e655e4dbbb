"""Plain PyTorch version of the block-sparse (ZTB) kernel: the masked
dense product.  The schedule and the mask must agree."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitlinear.ref import int_matmul


def expand_mask(block_nonzero: np.ndarray, k: int, n: int, *, bk: int,
                bn: int) -> np.ndarray:
    """bool [ceil(K/bk), ceil(N/bn)] block mask -> bool [K, N] element mask
    (the last block row/column may be ragged)."""
    mask = np.repeat(np.repeat(np.asarray(block_nonzero, dtype=bool), bk,
                               axis=0), bn, axis=1)
    if mask.shape[0] < k or mask.shape[1] < n:
        raise ValueError(f"block mask {block_nonzero.shape} at ({bk}, {bn}) "
                         f"does not cover w [{k}, {n}]")
    return mask[:k, :n]


def block_sparse_matmul_ref(
    x: torch.Tensor, w: torch.Tensor, block_nonzero: np.ndarray,
    *, bk: int, bn: int,
) -> torch.Tensor:
    """out = x @ (w masked to its non-zero blocks).

    Integer operands give the exact int32 product; anything else multiplies
    in float32.  ``block_nonzero``: bool [ceil(K/bk), ceil(N/bn)].
    """
    k, n = w.shape
    mask = torch.from_numpy(expand_mask(block_nonzero, k, n, bk=bk,
                                        bn=bn)).to(w.device)
    wm = w * mask.to(w.dtype)
    if not (x.dtype.is_floating_point or w.dtype.is_floating_point):
        return int_matmul(x, wm)
    return x.to(torch.float32) @ wm.to(torch.float32)
