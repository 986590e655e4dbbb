"""granite-moe-1b-a400m [moe] — 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", layers=24, d_model=1024,
        n_heads=16, kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        n_experts=32, top_k=8,
    )
