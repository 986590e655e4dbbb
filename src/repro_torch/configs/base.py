"""ModelConfig — one dataclass covering every assigned architecture family."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free (ssm)
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # pad the expert dim to a mesh-divisible count (dummy experts hold zero
    # weights and receive no tokens); 0 = no padding
    n_experts_padded: int = 0
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssd_chunk: int = 128
    # --- hybrid (Zamba2-style shared attention) ---
    attn_every: int = 0          # shared attn applied before every k-th block
    # --- modality frontend stubs ---
    frontend: str = "none"       # none | audio_frames | vision_patches
    num_patches: int = 0         # VLM: patches prepended to the sequence
    # --- quantization (BitNet b1.58 QAT on projections) ---
    quantization: str = "bitnet"   # bitnet | none
    weight_bits: int = 2
    # --- runtime ---
    causal: bool = True
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: str = "block"          # none | block (checkpoint each layer block)
    kernel_backend: str = "reference"   # reference | pallas (TPU)
    max_seq: int = 4096

    # ------------------------------------------------------------------ #
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_inner(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def group_size(self) -> int:
        return self.n_heads // max(self.kv_heads, 1)

    @property
    def n_experts_total(self) -> int:
        """Expert-dim size incl. sharding padding (>= n_experts)."""
        return max(self.n_experts_padded, self.n_experts)

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D model-FLOPs)."""
        d, l = self.d_model, self.layers
        n = self.vocab * d                       # embeddings
        if not self.tie_embeddings:
            n += self.vocab * d
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "vlm"):
            hd = self.head_dim_
            per_layer += d * self.n_heads * hd + 2 * d * self.kv_heads * hd
            per_layer += self.n_heads * hd * d   # out proj
            per_layer += 2 * d                   # norms
            if self.family == "moe":
                per_layer += d * self.n_experts  # router
                per_layer += self.n_experts * 3 * d * self.d_ff
            else:
                per_layer += 3 * d * self.d_ff   # swiglu
        elif self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            out_proj = di * d
            per_layer += in_proj + out_proj + 3 * nh + d  # +dt/A/D + norm
        n += per_layer * l
        if self.family == "hybrid" and self.attn_every:
            hd = self.head_dim_
            shared = d * self.n_heads * hd + 2 * d * self.kv_heads * hd
            shared += self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d
            n += shared                          # one shared block (Zamba2)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, l = self.d_model, self.layers
        inactive = (self.n_experts - self.top_k) * 3 * d * self.d_ff * l
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES: Tuple[ShapeConfig, ...] = (
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
