"""hubert-xlarge [audio] — encoder-only transformer backbone.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447;
unverified].  The conv feature extractor is a STUB: input_specs provides
precomputed frame embeddings [B, S, d_model].  No decode step exists —
decode shape cells are skipped (DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder", layers=48, d_model=1280,
        n_heads=16, kv_heads=16, head_dim=80, d_ff=5120, vocab=504,
        causal=False, frontend="audio_frames", tie_embeddings=False,
    )
