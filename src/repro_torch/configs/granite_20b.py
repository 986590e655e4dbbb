"""granite-20b [dense] — llama-arch code model, extreme MQA (kv=1).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324; hf]
kv=1 is the paper's best-case KV-multicast regime (reuse factor H/G = 48).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", layers=52, d_model=6144,
        n_heads=48, kv_heads=1, head_dim=128, d_ff=24576, vocab=49152,
    )
