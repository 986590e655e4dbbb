"""Data substrate: deterministic synthetic corpus + token shards + prefetch
(a numpy-only copy of the JAX package's ``data.pipeline``)."""
from repro_torch.data.pipeline import (
    Prefetcher,
    TokenShardReader,
    synthetic_batch,
    write_token_shard,
)
