"""Attention-workload extraction (paper SS V, Fig. 6).

Decomposes a transformer attention layer (prefill pass over sequence length S)
into the paper's four GEMM stages:

    qkv_proj     activation-to-weight, 2-bit weights (R=4), H + 2*G workloads
    attn_score   activation-to-activation Q @ K^T, int8 (R=1), H workloads
    attn_output  activation-to-activation A @ V,   int8 (R=1), H workloads
    out_proj     activation-to-weight, 2-bit weights (R=4), 1 workload

Each workload carries the data-reuse multipliers the D-Legion NoC exploits
(input multicast across Legions, KV multicast across GQA groups) so the
simulator can account memory traffic per architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List


# Stage names (paper Figs. 6-10 x-axis).
QKV_PROJ = "qkv_proj"
ATTN_SCORE = "attn_score"
ATTN_OUTPUT = "attn_output"
OUT_PROJ = "out_proj"
STAGES = (QKV_PROJ, ATTN_SCORE, ATTN_OUTPUT, OUT_PROJ)

# Split-projection stage names (``repro_torch.legion.program.lower_attention``
# with ``split_qkv=True``): Q/K/V as three independent workloads, so a
# program graph exposes their dependency-independence (V is not needed
# until the attn_output GEMM) to a pipelining executor.
Q_PROJ = "q_proj"
K_PROJ = "k_proj"
V_PROJ = "v_proj"

# Workload-zoo stage names (``repro_torch.legion.lowering``): the MoE FFN block
# (router + per-expert SwiGLU up/down — MLP names shared with the serve
# backend's dense projections) and the Mamba-2 SSD scan's chunked GEMMs.
ROUTER = "router"
MLP_UP = "mlp_up"        # w1 & w3: [d_model, d_ff], two instances, shared x
MLP_DOWN = "mlp_down"    # w2:      [d_ff, d_model]
SSD_SCORE = "ssd_score"  # C_c @ B_c^T     [q, n] @ [n, q], group-shared
SSD_INTRA = "ssd_intra"  # (scores*decay) @ dtx_c   [q, q] @ [q, p] per head
SSD_STATE = "ssd_state"  # (B_c*decay)^T @ dtx_c    [n, q] @ [q, p] per head
SSD_INTER = "ssd_inter"  # (C_c*exp(la)) @ h_prev   [q, n] @ [n, p] per head

# Mapping policy per stage (paper SS IV-C):
#   head_per_unit — each Legion takes one head workload, round-robin
#   n_partition   — the workload's N dim is split across all Legions
HEAD_PER_UNIT = "head_per_unit"
N_PARTITION = "n_partition"


@dataclasses.dataclass(frozen=True)
class GEMMWorkload:
    """One GEMM: out[M,N] = act[M,K] @ w[K,N], repeated ``count`` times."""

    stage: str
    m: int
    k: int
    n: int
    weight_bits: int        # 2 for ternary projections, 8 for act-to-act
    count: int = 1          # independent instances (e.g. one per head)
    # Data-reuse annotations (D-Legion NoC multicast, paper SS IV-B):
    shared_input: bool = False   # all `count` instances stream the same input
    kv_group: int = 1            # stationary matrix shared by kv_group heads
    mapping: str = HEAD_PER_UNIT
    layers: int = 1              # replicate per model layer
    # Paged-KV annotations: the stationary operand is a KV-cache matrix
    # block-allocated in fixed ``page_tokens``-token pages along
    # ``page_axis`` ("n" for attn_score's [hd, t] K^T, "k" for
    # attn_output's [t, hd] V).  0 / "" = contiguous (no page modeling).
    page_tokens: int = 0
    page_axis: str = ""

    def __post_init__(self):
        if self.page_tokens < 0:
            raise ValueError(f"page_tokens must be >= 0, got "
                             f"{self.page_tokens}")
        if bool(self.page_tokens) != bool(self.page_axis):
            raise ValueError(
                f"page_tokens={self.page_tokens} and page_axis="
                f"{self.page_axis!r} must be set together"
            )
        if self.page_axis not in ("", "n", "k"):
            raise ValueError(f"page_axis must be 'n' or 'k', got "
                             f"{self.page_axis!r}")

    @property
    def page_token_count(self) -> int:
        """Logical tokens along the paged axis (0 when un-paged)."""
        if not self.page_tokens:
            return 0
        return self.n if self.page_axis == "n" else self.k

    @property
    def page_count(self) -> int:
        """Pages covering the token axis: ceil(tokens / page_tokens)."""
        if not self.page_tokens:
            return 0
        return -(-self.page_token_count // self.page_tokens)

    @property
    def page_waste_tokens(self) -> int:
        """Last-page padding: allocated minus logical tokens."""
        if not self.page_tokens:
            return 0
        return self.page_count * self.page_tokens - self.page_token_count

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count * self.layers

    @property
    def ops(self) -> int:
        """Multiplications + additions (paper's 'workload size')."""
        return 2 * self.macs


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Minimal attention geometry — constructed from any registry arch."""

    name: str
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    seq_len: int
    weight_bits: int = 2   # BitNet b1.58 ternary

    @property
    def attn_inner(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_inner(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return self.heads // self.kv_heads


def bitnet_1_58b(seq_len: int = 2048) -> AttentionSpec:
    """BitNet-1.58B: 32L, hidden 2560, 16 MHA heads x 128 (paper SS V)."""
    return AttentionSpec(
        name="BitNet-1.58B", layers=32, hidden=2560, heads=16, kv_heads=16,
        head_dim=128, seq_len=seq_len,
    )


def bitnet_1_58b_kv(seq_len: int = 2048) -> AttentionSpec:
    """BitNet-1.58B-KV: same but GQA with 4 KV heads (paper SS V)."""
    return AttentionSpec(
        name="BitNet-1.58B-KV", layers=32, hidden=2560, heads=16, kv_heads=4,
        head_dim=128, seq_len=seq_len,
    )


def attention_workloads(spec: AttentionSpec) -> List[GEMMWorkload]:
    """The paper's four attention stages for a prefill pass of S tokens."""
    s, h, g, hd = spec.seq_len, spec.heads, spec.kv_heads, spec.head_dim
    return [
        # Q/K/V projections: one workload per produced head; all share the
        # same streamed input X[S, hidden] (multicast across Legions).
        GEMMWorkload(
            stage=QKV_PROJ, m=s, k=spec.hidden, n=hd,
            weight_bits=spec.weight_bits, count=h + 2 * g,
            shared_input=True, mapping=HEAD_PER_UNIT, layers=spec.layers,
        ),
        # Attention scores Q @ K^T per query head; stationary K shared by
        # each GQA group (KV multicast, reuse factor H/G).
        GEMMWorkload(
            stage=ATTN_SCORE, m=s, k=hd, n=s, weight_bits=8, count=h,
            kv_group=spec.group_size, mapping=N_PARTITION, layers=spec.layers,
        ),
        # Attention output A @ V per head; stationary V shared per group.
        GEMMWorkload(
            stage=ATTN_OUTPUT, m=s, k=s, n=hd, weight_bits=8, count=h,
            kv_group=spec.group_size, mapping=N_PARTITION, layers=spec.layers,
        ),
        # Output projection: single large GEMM, N-partitioned across Legions.
        GEMMWorkload(
            stage=OUT_PROJ, m=s, k=spec.attn_inner, n=spec.hidden,
            weight_bits=spec.weight_bits, count=1,
            mapping=N_PARTITION, layers=spec.layers,
        ),
    ]


def decode_attention_workloads(
    *, heads: int, kv_heads: int, head_dim: int, context: int, m: int = 1,
    layers: int = 1, page_tokens: int = 0,
) -> List[GEMMWorkload]:
    """The act-to-act stages of ONE serving step at a KV context length.

    Decode-shaped when ``m=1`` (one query row per step), prefill-shaped when
    ``m == context``.  K/N are position-dependent: at context ``t`` the
    score GEMM is ``[m, hd] @ [hd, t]`` and the output GEMM ``[m, t] @
    [t, hd]`` — the KV-cache matrices are the stationary operands, shared
    across each GQA group (multicast reuse factor ``heads / kv_heads``).

    With ``page_tokens > 0`` the stationary KV operands are annotated as
    block-allocated pages along the token axis (score: N, output: K) —
    the runtime then fires per-page fetch events and both it and the
    analytic model account the last page's padding as extra stationary
    traffic (page-boundary waste).
    """
    if context < 1:
        raise ValueError(f"context must be >= 1, got {context}")
    gs = max(heads // max(kv_heads, 1), 1)
    common = dict(weight_bits=8, count=heads, kv_group=gs,
                  mapping=N_PARTITION, layers=layers)
    return [
        GEMMWorkload(stage=ATTN_SCORE, m=m, k=head_dim, n=context,
                     page_tokens=page_tokens,
                     page_axis="n" if page_tokens else "", **common),
        GEMMWorkload(stage=ATTN_OUTPUT, m=m, k=context, n=head_dim,
                     page_tokens=page_tokens,
                     page_axis="k" if page_tokens else "", **common),
    ]


def moe_ffn_workloads(
    *, tokens: int, d_model: int, d_ff: int, n_experts: int,
    weight_bits: int = 2, layers: int = 1,
) -> List[GEMMWorkload]:
    """The MoE FFN block's GEMM stages: router + ONE expert's SwiGLU pair.

    The router is a single int8 GEMM over all tokens; each expert runs the
    same SwiGLU shapes as a dense MLP (w1/w3 share the streamed tokens,
    w2 consumes the combined gate*value).  ``repro_torch.legion.lowering``
    instantiates the expert pair once per expert — the k-of-E routing
    decision then gates unchosen experts' stages as fully-sparse ZTB
    windows, so these templates describe BOTH the dense-E and the k-of-E
    step (the difference is program-level sparsity, not shape).
    """
    return [
        GEMMWorkload(stage=ROUTER, m=tokens, k=d_model, n=n_experts,
                     weight_bits=8, count=1, mapping=N_PARTITION,
                     layers=layers),
        GEMMWorkload(stage=MLP_UP, m=tokens, k=d_model, n=d_ff,
                     weight_bits=weight_bits, count=2, shared_input=True,
                     mapping=HEAD_PER_UNIT, layers=layers),
        GEMMWorkload(stage=MLP_DOWN, m=tokens, k=d_ff, n=d_model,
                     weight_bits=weight_bits, count=1, mapping=N_PARTITION,
                     layers=layers),
    ]


def ssd_chunk_workloads(
    *, heads: int, chunk: int, state: int, head_dim: int, layers: int = 1,
) -> List[GEMMWorkload]:
    """ONE chunk of the Mamba-2 SSD scan as act-to-act GEMM stages.

    Shapes follow ``kernels/ssd``'s chunked decomposition (chunk length
    ``q``, state width ``n``, head dim ``p``): the score GEMM
    ``C_c B_c^T`` is computed once per chunk (B/C are group-shared in
    Mamba-2, ``n_groups=1`` — the same reuse ``ssd_grouped_scan``
    exploits), while the intra-chunk output, chunk-state, and inter-chunk
    output GEMMs run per head.  All stages are int8 act-to-act (the scan
    is activation math; decays fold into inter-stage transforms).  The
    inter stage's stationary operand is the recurrent state — produced by
    *earlier chunks'* state stages, the cross-chunk dependency
    ``repro_torch.legion.lowering.lower_ssd`` wires as a stationary ``Ref``.
    """
    common = dict(weight_bits=8, count=heads, mapping=N_PARTITION,
                  layers=layers)
    return [
        GEMMWorkload(stage=SSD_SCORE, m=chunk, k=state, n=chunk,
                     weight_bits=8, count=1, mapping=N_PARTITION,
                     layers=layers),
        GEMMWorkload(stage=SSD_INTRA, m=chunk, k=chunk, n=head_dim,
                     **common),
        GEMMWorkload(stage=SSD_STATE, m=state, k=chunk, n=head_dim,
                     **common),
        GEMMWorkload(stage=SSD_INTER, m=chunk, k=state, n=head_dim,
                     **common),
    ]


def total_ops(workloads) -> int:
    return sum(w.ops for w in workloads)


def corner_case_workloads(
    seq_len: int = 2048, hidden: int = 2560, head_dim: int = 64,
) -> List[GEMMWorkload]:
    """DSE corner-case workloads (paper SS III-A/B): head size 64."""
    return [
        GEMMWorkload(stage=QKV_PROJ, m=seq_len, k=hidden, n=head_dim,
                     weight_bits=2),
        GEMMWorkload(stage=ATTN_SCORE, m=seq_len, k=head_dim, n=seq_len,
                     weight_bits=8),
        GEMMWorkload(stage=ATTN_OUTPUT, m=seq_len, k=seq_len, n=head_dim,
                     weight_bits=8),
    ]


def iter_stage(workloads, stage: str) -> Iterator[GEMMWorkload]:
    return (w for w in workloads if w.stage == stage)
