"""internvl2-76b [vlm] — InternLM2-style LM backbone (largest cell).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified].  The InternViT frontend is a STUB:
input_specs provides precomputed patch embeddings prepended to the text.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm", layers=80, d_model=8192,
        n_heads=64, kv_heads=8, head_dim=128, d_ff=28672, vocab=128256,
        frontend="vision_patches", num_patches=256, tie_embeddings=False,
    )
