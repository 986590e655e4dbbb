"""starcoder2-3b [dense] — GQA + RoPE code model.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense", layers=30, d_model=3072,
        n_heads=24, kv_heads=2, head_dim=128, d_ff=12288, vocab=49152,
    )
