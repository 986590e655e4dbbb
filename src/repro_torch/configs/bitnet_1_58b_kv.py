"""BitNet-1.58B-KV — the paper's GQA variant (4 KV heads, SS V)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="bitnet-1.58b-kv", family="dense", layers=32, d_model=2560,
        n_heads=16, kv_heads=4, head_dim=128, d_ff=6912, vocab=32000,
        max_seq=2048,
    )
