"""Data pipeline: deterministic synthetic corpus + binary shard reader with
per-host sharded batching and background prefetch.

Determinism contract (fault tolerance depends on it): a batch is a pure
function of (seed, step, arch) — no iterator state.  A restarted, elastically
re-sharded, or straggler-shadowing host reproduces the exact global batch by
slicing the same deterministic stream.
"""
from __future__ import annotations

import hashlib
import os
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


def _seed_for(seed: int, step: int, tag: str) -> int:
    h = hashlib.blake2b(
        f"{seed}:{step}:{tag}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "little") % (2**63)


def synthetic_batch(
    cfg, *, batch: int, seq: int, step: int, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Deterministic batch for any registry arch (tokens / frames / patches).

    Token streams are Zipf-ish so losses behave like real text rather than
    uniform noise.
    """
    rng = np.random.default_rng(_seed_for(seed, step, cfg.name))
    out: Dict[str, np.ndarray] = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32
        )
        out["targets"] = rng.integers(0, cfg.vocab, (batch, seq),
                                      dtype=np.int32)
        return out
    ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = (ranks % (cfg.vocab - 1)) + 1
    if cfg.frontend == "vision_patches":
        text = seq - cfg.num_patches
        out["tokens"] = toks[:, :text].astype(np.int32)
        out["targets"] = toks[:, 1:text + 1].astype(np.int32)
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.num_patches, cfg.d_model), dtype=np.float32
        )
    else:
        out["tokens"] = toks[:, :seq].astype(np.int32)
        out["targets"] = toks[:, 1:].astype(np.int32)
    return out


# --------------------------------------------------------------------------- #
# Binary token shards (uint16/uint32 memmap) — the "real corpus" path
# --------------------------------------------------------------------------- #

def write_token_shard(path: str, tokens: np.ndarray) -> None:
    dtype = np.uint16 if tokens.max() < 2**16 else np.uint32
    tokens.astype(dtype).tofile(path)
    with open(path + ".meta", "w") as f:
        f.write(f"{dtype.__name__ if hasattr(dtype,'__name__') else dtype}"
                f" {tokens.size}")


class TokenShardReader:
    """Memmapped token shard with deterministic (step -> batch) addressing."""

    def __init__(self, path: str, *, vocab: int):
        with open(path + ".meta") as f:
            dtype_name, size = f.read().split()
        self.tokens = np.memmap(path, dtype=np.dtype(dtype_name), mode="r",
                                shape=(int(size),))
        self.vocab = vocab

    def batch(self, *, batch: int, seq: int, step: int,
              host: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Global batch is split evenly across hosts; addressing is pure in
        (step, host) so any host can recompute any shard."""
        per_host = batch // num_hosts
        n = self.tokens.size - (seq + 1)
        idx_rng = np.random.default_rng(_seed_for(0, step, "addr"))
        starts = idx_rng.integers(0, n, size=(batch,))
        starts = starts[host * per_host:(host + 1) * per_host]
        toks = np.stack([self.tokens[s:s + seq + 1] for s in starts])
        toks = toks.astype(np.int32) % self.vocab
        return {"tokens": toks[:, :seq], "targets": toks[:, 1:]}


class Prefetcher:
    """Double-buffered background prefetch around any batch_fn(step)."""

    def __init__(self, batch_fn: Callable[[int], Dict], *, depth: int = 2):
        self.batch_fn = batch_fn
        self.depth = depth

    def __call__(self, start_step: int, total: int) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = object()

        def worker():
            for s in range(start_step, total):
                q.put((s, self.batch_fn(s)))
            q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item
