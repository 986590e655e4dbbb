"""smollm-360m [dense] — llama-arch small model.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
15 heads do not divide the 16-wide model axis: attention is replicated and
TP lands on d_ff (sharding rules fall back automatically).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", layers=32, d_model=960,
        n_heads=15, kv_heads=5, head_dim=64, d_ff=2560, vocab=49152,
    )
