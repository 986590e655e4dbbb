"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified]
Shared attn block applied before every 6th SSM block (weight-tied).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", layers=81, d_model=3584,
        n_heads=32, kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
        ssm_state=64, ssm_head_dim=64, attn_every=6,
    )
