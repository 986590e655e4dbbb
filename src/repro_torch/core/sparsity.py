"""Zero-Tile Book (ZTB) — block-structured sparsity (paper SS IV-A.4).

The ZTB is a per-Legion bitmask table recording which *windows* of weight
tiles are structurally zero, determined offline.  A window covers C tiles
(one per core) along the K dimension:

    weight[K, N]  ->  tile grid [ceil(K/D), ceil(N/D)]
                  ->  windows   [ceil(K/(C*D)), C, ceil(N/D)]

* fully-sparse window   — all C tiles zero: the mapper cancels transfers,
  disables the cores, and skips accumulator updates (one whole KT step).
* partially-sparse window — only the cores holding zero tiles deactivate
  (energy saving; latency unchanged, the window still executes).

The same book drives (a) the cycle simulator, (b) the Pallas block-sparse
kernel (as a CSR-of-blocks schedule prefetched into SMEM), and (c) the
sparse-mode reference ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ZTBStats:
    fully_sparse_fraction: float   # fraction of windows with all-zero tiles
    zero_tile_fraction: float      # fraction of individual zero tiles
    num_windows: int
    num_tiles: int


@dataclasses.dataclass(frozen=True)
class ZeroTileBook:
    """``tile_nonzero[w, c, nt]`` — True if tile (window w, core c, col nt)
    holds any non-zero weight."""

    tile_nonzero: np.ndarray   # bool [KW, C, NT]
    block_k: int               # D
    block_n: int               # D (or R*D in projection mode)
    window: int                # C

    @property
    def window_nonzero(self) -> np.ndarray:
        """bool [KW, NT] — False = fully-sparse window (skippable)."""
        return self.tile_nonzero.any(axis=1)

    def stats(self) -> ZTBStats:
        wn = self.window_nonzero
        return ZTBStats(
            fully_sparse_fraction=float(1.0 - wn.mean()) if wn.size else 0.0,
            zero_tile_fraction=float(1.0 - self.tile_nonzero.mean())
            if self.tile_nonzero.size else 0.0,
            num_windows=int(wn.size),
            num_tiles=int(self.tile_nonzero.size),
        )


def ztb_from_weight(
    weight: np.ndarray, *, block_k: int, block_n: int, window: int,
) -> ZeroTileBook:
    """Build the book offline from a (possibly pruned) weight matrix [K, N]."""
    k, n = weight.shape
    kt = math.ceil(k / block_k)
    nt = math.ceil(n / block_n)
    kw = math.ceil(kt / window)
    nz = np.zeros((kw * window, nt), dtype=bool)
    for i in range(kt):
        for j in range(nt):
            blk = weight[i * block_k:(i + 1) * block_k,
                         j * block_n:(j + 1) * block_n]
            nz[i, j] = bool(np.any(blk != 0))
    return ZeroTileBook(
        tile_nonzero=nz.reshape(kw, window, nt),
        block_k=block_k, block_n=block_n, window=window,
    )


def prune_block_structured(
    weight: np.ndarray, *, block_k: int, block_n: int, sparsity: float,
    seed: int = 0,
) -> np.ndarray:
    """Zero out whole (block_k x block_n) tiles, lowest-magnitude first, until
    ``sparsity`` of the tiles are zero — produces ZTB-friendly weights."""
    k, n = weight.shape
    kt, nt = math.ceil(k / block_k), math.ceil(n / block_n)
    mags = np.zeros((kt, nt))
    for i in range(kt):
        for j in range(nt):
            blk = weight[i * block_k:(i + 1) * block_k,
                         j * block_n:(j + 1) * block_n]
            mags[i, j] = np.abs(blk).sum()
    order = np.argsort(mags, axis=None, kind="stable")
    n_zero = int(round(sparsity * kt * nt))
    out = weight.copy()
    for flat in order[:n_zero]:
        i, j = divmod(int(flat), nt)
        out[i * block_k:(i + 1) * block_k, j * block_n:(j + 1) * block_n] = 0
    return out


def csr_block_schedule(
    block_nonzero: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR-of-blocks schedule for the Pallas kernel.

    For each N-tile column ``j``: ``indices[j, :counts[j]]`` lists the
    non-zero K-tile rows (fully-sparse windows simply never appear).
    ``indices`` is padded with the last valid index so prefetched lookups
    stay in bounds; ``counts[j]`` guards execution via ``@pl.when``.

    Args:
      block_nonzero: bool [KT, NT].
    Returns:
      (indices int32 [NT, KT], counts int32 [NT])
    """
    kt, nt = block_nonzero.shape
    indices = np.zeros((nt, kt), dtype=np.int32)
    counts = np.zeros((nt,), dtype=np.int32)
    for j in range(nt):
        nz = np.nonzero(block_nonzero[:, j])[0].astype(np.int32)
        counts[j] = len(nz)
        if len(nz):
            indices[j, :len(nz)] = nz
            indices[j, len(nz):] = nz[-1]
    return indices, counts
