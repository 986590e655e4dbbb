"""BitNet-1.58B — the paper's own evaluation model (SS V).

32L hidden=2560 16 MHA heads x 128 (attn inner 2048), seq 2048, ternary
weights (BitNet b1.58 QAT).  d_ff chosen at the usual ~2.7x hidden.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="bitnet-1.58b", family="dense", layers=32, d_model=2560,
        n_heads=16, kv_heads=16, head_dim=128, d_ff=6912, vocab=32000,
        max_seq=2048,
    )
