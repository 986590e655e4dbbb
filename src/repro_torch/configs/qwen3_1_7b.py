"""qwen3-1.7b [dense] — qk_norm + GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense", layers=28, d_model=2048,
        n_heads=16, kv_heads=8, head_dim=128, d_ff=6144, vocab=151936,
        qk_norm=True, rope_theta=1e6,
    )
