"""Legion runtime — executes scheduler StagePlans through the kernels.

The port of ``repro.legion``, this slice's modules:

- machine:  `Machine` session facade — pluggable `Instrument` measurement
            hooks + `ExecutorBackend` numerics (in-process on the session's
            device, or pipelined over a program's dependency levels)
- program:  `Program` stage graphs — named GEMM nodes with explicit data
            dependencies and operand sources, attention + serve-step
            lowering builders, the overlapped-round pipeline model, and a
            pure-NumPy reference execution
- runtime:  plan coverage validation, operand synthesis
- modes:    adaptive-precision mode selection (W1.58 / W4 / W8, +ZTB)
- trace:    NoC-dedup traffic measurement + simulate() cross-validation
- latency:  cycle counting (fill/stream/drain/prefetch) + eq.-2 cross-val

``lowering``, ``roofline`` and ``ShardedExecutor`` wait for later slices
(ROADMAP.md, Queue 1).
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
    "CycleBreakdown",
    "CycleCounter",
    "CycleValidation",
    "ExecContext",
    "ExecutorBackend",
    "InProcessExecutor",
    "Instrument",
    "LevelTiming",
    "Machine",
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
    "StageValidation",
    "TrafficTotals",
    "TrafficTracer",
    "compute_pipeline",
    "cross_validate",
    "cross_validate_cycles",
    "lower_attention",
    "lower_serve_batch",
    "lower_serve_mixed",
    "lower_serve_step",
    "merge_round_criticals",
    "prepare_context",
    "reference_outputs",
    "requantize_int8",
    "run_assignment_loop",
    "select_mode",
    "softmax_int8",
    "swiglu_int8",
    "synthesize_operands",
    "total_cycle_error",
    "validate_coverage",
    "validate_mem_bw",
    "validate_options",
]
