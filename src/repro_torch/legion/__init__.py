"""Legion runtime — executes scheduler StagePlans through the kernels.

The port of ``repro.legion``, this slice's modules:

- machine:  `Machine` session facade — pluggable `Instrument` measurement
            hooks + `ExecutorBackend` numerics (in-process on the session's
            device, or pipelined over a program's dependency levels)
- program:  `Program` stage graphs — named GEMM nodes with explicit data
            dependencies and operand sources, attention + serve-step
            lowering builders, the overlapped-round pipeline model, and a
            pure-NumPy reference execution
- lowering: the workload zoo's unified `lower(spec)` front door — the
            `LoweringSpec` dataclass family covering attention, the
            serve-step graphs, MoE expert-skip (`lower_moe`), the
            Mamba-2 SSD scan (`lower_ssd`), and the Zamba2-style hybrid
            (`lower_hybrid`), plus `zoo_spec` mapping any registry
            ModelConfig to its family's spec
- runtime:  plan coverage validation, operand synthesis
- modes:    adaptive-precision mode selection (W1.58 / W4 / W8, +ZTB)
- trace:    NoC-dedup traffic measurement + simulate() cross-validation
- latency:  cycle counting (fill/stream/drain/prefetch) + eq.-2 cross-val
- roofline: finite-bandwidth sweeps — the stall knee, the paper's HBM
            budget, counted-vs-analytic stall cross-validation

``ShardedExecutor`` waits for a later slice (ROADMAP.md, Queue 1).
"""
from repro_torch.legion.latency import (
    CycleBreakdown,
    CycleCounter,
    CycleValidation,
    cross_validate_cycles,
    merge_round_criticals,
    total_cycle_error,
    validate_mem_bw,
)
from repro_torch.legion.lowering import (
    AttentionLoweringSpec,
    HybridSpec,
    LoweringSpec,
    MoESpec,
    SSDSpec,
    ServeBatchSpec,
    ServeMixedSpec,
    ServeStepSpec,
    lower,
    lower_hybrid,
    lower_moe,
    lower_ssd,
    moe_stage_names,
    ssd_stage_names,
    zoo_spec,
)
from repro_torch.legion.machine import (
    ExecContext,
    ExecutorBackend,
    InProcessExecutor,
    Instrument,
    Machine,
    PipelinedExecutor,
    RunReport,
    prepare_context,
    run_assignment_loop,
    validate_options,
)
from repro_torch.legion.modes import ModeSpec, select_mode
from repro_torch.legion.program import (
    LevelTiming,
    PipelineReport,
    Program,
    ProgramError,
    ProgramReport,
    ProgramStage,
    Ref,
    compute_pipeline,
    lower_attention,
    lower_serve_batch,
    lower_serve_mixed,
    lower_serve_step,
    reference_outputs,
    requantize_int8,
    softmax_int8,
    swiglu_int8,
)
from repro_torch.legion.roofline import (
    BandwidthSweep,
    SweepPoint,
    find_stall_knee,
    hbm_bytes_per_cycle,
    sweep_bandwidth,
)
from repro_torch.legion.runtime import (
    PlanCoverageError,
    synthesize_operands,
    validate_coverage,
)
from repro_torch.legion.trace import (
    StageValidation,
    TrafficTotals,
    TrafficTracer,
    cross_validate,
)

__all__ = [
    "AttentionLoweringSpec",
    "BandwidthSweep",
    "CycleBreakdown",
    "CycleCounter",
    "CycleValidation",
    "ExecContext",
    "ExecutorBackend",
    "HybridSpec",
    "InProcessExecutor",
    "Instrument",
    "LevelTiming",
    "LoweringSpec",
    "Machine",
    "MoESpec",
    "ModeSpec",
    "PipelineReport",
    "PipelinedExecutor",
    "PlanCoverageError",
    "Program",
    "ProgramError",
    "ProgramReport",
    "ProgramStage",
    "Ref",
    "RunReport",
    "SSDSpec",
    "ServeBatchSpec",
    "ServeMixedSpec",
    "ServeStepSpec",
    "StageValidation",
    "SweepPoint",
    "TrafficTotals",
    "TrafficTracer",
    "compute_pipeline",
    "cross_validate",
    "cross_validate_cycles",
    "find_stall_knee",
    "hbm_bytes_per_cycle",
    "lower",
    "lower_attention",
    "lower_hybrid",
    "lower_moe",
    "lower_serve_batch",
    "lower_serve_mixed",
    "lower_serve_step",
    "lower_ssd",
    "merge_round_criticals",
    "moe_stage_names",
    "prepare_context",
    "reference_outputs",
    "requantize_int8",
    "run_assignment_loop",
    "select_mode",
    "softmax_int8",
    "ssd_stage_names",
    "sweep_bandwidth",
    "swiglu_int8",
    "synthesize_operands",
    "total_cycle_error",
    "validate_coverage",
    "validate_mem_bw",
    "validate_options",
    "zoo_spec",
]
