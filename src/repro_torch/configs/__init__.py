"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    bitnet_1_58b,
    bitnet_1_58b_kv,
    granite_20b,
    granite_moe_1b_a400m,
    granite_moe_3b_a800m,
    hubert_xlarge,
    internvl2_76b,
    mamba2_130m,
    qwen3_1_7b,
    smollm_360m,
    starcoder2_3b,
    zamba2_7b,
)
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    shape_by_name,
)

_MODULES = {
    "granite-20b": granite_20b,
    "smollm-360m": smollm_360m,
    "starcoder2-3b": starcoder2_3b,
    "qwen3-1.7b": qwen3_1_7b,
    "zamba2-7b": zamba2_7b,
    "mamba2-130m": mamba2_130m,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "hubert-xlarge": hubert_xlarge,
    "internvl2-76b": internvl2_76b,
    "bitnet-1.58b": bitnet_1_58b,
    "bitnet-1.58b-kv": bitnet_1_58b_kv,
}

ASSIGNED_ARCHS: List[str] = [
    "granite-20b", "smollm-360m", "starcoder2-3b", "qwen3-1.7b",
    "zamba2-7b", "mamba2-130m", "granite-moe-1b-a400m",
    "granite-moe-3b-a800m", "hubert-xlarge", "internvl2-76b",
]


def arch_names() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_MODULES)}")
    return _MODULES[name].config()


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family variant for CPU smoke tests (assignment: reduced
    layers/width/experts/vocab; one forward/train step must run on CPU)."""
    kw = dict(
        name=cfg.name + "-smoke",
        layers=4 if cfg.family == "hybrid" else 2,
        d_model=128,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab=512,
        max_seq=128,
        remat="none",
    )
    if cfg.n_heads:
        kw.update(
            n_heads=4,
            kv_heads=1 if cfg.kv_heads == 1 else (
                4 if cfg.kv_heads == cfg.n_heads else 2
            ),
            head_dim=32,
        )
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=2, d_ff=64, n_experts_padded=0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=32)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    if cfg.frontend == "vision_patches":
        kw.update(num_patches=8)
    return cfg.replace(**kw)


# Shape applicability (DESIGN.md SS4): which cells run vs. are skipped.
def applicable_shapes(cfg: ModelConfig) -> Dict[str, str]:
    """shape name -> "run" or reason for skipping."""
    out: Dict[str, str] = {}
    for shape in ALL_SHAPES:
        if shape.kind == "decode" and not cfg.is_decoder:
            out[shape.name] = "skip: encoder-only arch has no decode step"
        elif (shape.name == "long_500k"
              and cfg.family not in ("ssm", "hybrid")):
            out[shape.name] = (
                "skip: 512k decode needs sub-quadratic attention; arch is "
                "pure full-attention"
            )
        else:
            out[shape.name] = "run"
    return out
