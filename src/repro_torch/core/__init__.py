"""D-Legion core: the paper's contribution as composable, testable pieces.

- config:     architecture configs (WS / DiP / ADiP / D-Legion / TPUv4i)
- analytical: eqs (1)-(3), TFU, peak TOPS, CRI, HBM scaling bound
- workloads:  attention-stage GEMM extraction (MHA / GQA, BitNet models)
- scheduler:  orchestrator mapping plans (head-per-Legion, N-partition, KV
              multicast)
- simulator:  cycle + traffic simulation reproducing the paper's figures
- sparsity:   zero-tile book (ZTB) block-structured sparsity
"""
from repro_torch.core import analytical, config, scheduler, simulator, sparsity, workloads
from repro_torch.core.config import (
    AcceleratorConfig,
    Dataflow,
    adip_64,
    dip_64,
    dlegion,
    tpuv4i,
    ws_64,
)
from repro_torch.core.simulator import (
    SimReport,
    StageResult,
    compare,
    simulate,
    simulate_workload,
)
from repro_torch.core.sparsity import (
    ZeroTileBook,
    ZTBStats,
    csr_block_schedule,
    prune_block_structured,
    ztb_from_weight,
)
from repro_torch.core.workloads import (
    AttentionSpec,
    GEMMWorkload,
    attention_workloads,
    bitnet_1_58b,
    bitnet_1_58b_kv,
    corner_case_workloads,
    decode_attention_workloads,
)

__all__ = [
    "AcceleratorConfig", "Dataflow", "ws_64", "dip_64", "adip_64",
    "dlegion", "tpuv4i", "SimReport", "StageResult", "simulate",
    "simulate_workload", "compare",
    "ZeroTileBook", "ZTBStats", "ztb_from_weight", "prune_block_structured",
    "csr_block_schedule", "AttentionSpec", "GEMMWorkload",
    "attention_workloads", "bitnet_1_58b", "bitnet_1_58b_kv",
    "corner_case_workloads", "decode_attention_workloads",
    "analytical", "config", "scheduler",
    "simulator", "sparsity", "workloads",
]
