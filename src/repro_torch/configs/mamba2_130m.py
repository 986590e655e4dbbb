"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060;
unverified].  The paper's attention-stage mapping is inapplicable
(DESIGN.md SSArch-applicability); in/out projections still run BitLinear.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm", layers=24, d_model=768,
        n_heads=0, kv_heads=0, d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64,
    )
