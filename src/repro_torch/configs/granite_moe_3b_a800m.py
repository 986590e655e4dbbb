"""granite-moe-3b-a800m [moe] — 40 experts, top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
40 experts do not divide the 16-wide model axis: the expert dim is PADDED
to 48 (dummy experts hold zero weights, receive no tokens) so EP shards
3-per-chip instead of replicating — see EXPERIMENTS.md SSPerf hillclimb 2.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", layers=32, d_model=1536,
        n_heads=24, kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        n_experts=40, top_k=8, n_experts_padded=48,
    )
