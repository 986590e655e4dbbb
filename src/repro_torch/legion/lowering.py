"""The workload zoo's unified lowering front door — ``legion.lower(spec)``.

Every lowering the repo knows — the paper's BitNet attention block, the
serve-step/batch/mixed graphs, and the two zoo additions below — now
dispatches through one entry point on a :class:`LoweringSpec` dataclass
family.  Specs validate at *construction* (``__post_init__``), so a bad
combination (attention with page tables, zero experts, a chosen set wider
than top-k) raises before any lowering work starts; the legacy
``lower_attention`` / ``lower_serve_*`` call-site signatures remain as
thin documented aliases in :mod:`repro_torch.legion.program`.

Zoo additions:

* :func:`lower_moe` — a token-choice MoE FFN block (router + ``E``
  experts' SwiGLU pairs) where the router's top-k decision becomes
  **program-level sparsity**: chosen experts' up/down GEMM stages execute
  normally, while each unchosen expert's stages carry zeroed weights with
  ``ztb=True`` — the runtime's self-derived ZeroTileBooks then gate every
  window, so `TrafficTracer`/`CycleCounter` measure the paper's
  fully-sparse-window skip at expert granularity (the AxLLM
  computation-reuse angle riding the ADiP adaptive cores).  Traffic for a
  k-of-E step equals the dense-E step minus the skipped experts'
  stationary bytes, exactly — and because the gated windows hold only
  zeros, the program still matches the dense NumPy
  :func:`~repro_torch.legion.program.reference_outputs` bit for bit (an
  unchosen expert contributes zeros on both sides).

* :func:`lower_ssd` — the Mamba-2 SSD scan's chunked state/output GEMMs
  (``kernels/ssd`` shapes: score ``C_c B_c^T`` computed once per chunk,
  per-head intra-chunk output, chunk-state, and inter-chunk output) as
  ``ProgramStage``\\ s, with the recurrent state threaded as a
  **cross-chunk stationary Ref**: chunk ``c``'s inter stage holds
  ``h_{c-1}`` stationary, produced from every earlier chunk's state stage
  through the decay recurrence folded into the Ref transform.  All decay
  factors are deterministic NumPy transforms between int8 GEMMs, so the
  whole scan stays bit-exact against ``reference_outputs`` and every
  stage cross-validates against ``simulate()`` at exactly 0%.

* :func:`lower_hybrid` — the Zamba2-style interleaving: one shared
  attention block's program sequenced before an SSD block's chunk
  stages (control dependencies on the SSD roots), merged with
  ``{attn}`` / ``{ssm}`` name tags.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.workloads import (
    MLP_DOWN,
    MLP_UP,
    ROUTER,
    SSD_INTER,
    SSD_INTRA,
    SSD_SCORE,
    SSD_STATE,
    AttentionSpec,
    moe_ffn_workloads,
    ssd_chunk_workloads,
)
from repro_torch.legion.program import (
    STATIONARY_ACT,
    Program,
    ProgramStage,
    Ref,
    lower_attention,
    lower_serve_batch,
    lower_serve_mixed,
    lower_serve_step,
    requantize_int8,
    swiglu_int8,
)

_WEIGHT_RANGES = {2: (-1, 2), 4: (-8, 8), 8: (-8, 9)}


# --------------------------------------------------------------------------- #
# Spec family
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True, kw_only=True)
class LoweringSpec:
    """Shared fields of every lowering spec.

    ``weight_bits`` is the stationary-weight precision of the lowered
    projection stages (act-to-act stages are always int8); ``layers``
    replicates whole-model tallies the usual scalar way; ``tag``
    optionally suffixes every stage name (:meth:`Program.merge` tagging,
    for composing lowered blocks); ``page_tokens``/``page_tables``
    annotate paged stationary KV operands — only the serve specs have
    any, so setting them elsewhere raises at construction.
    """

    weight_bits: int = 2
    layers: int = 1
    seed: int = 0
    tag: str = ""
    page_tokens: int = 0
    page_tables: Optional[Sequence[Sequence[int]]] = None

    _PAGED = False      # ClassVar by convention: which specs accept paging

    def __post_init__(self) -> None:
        if self.weight_bits not in (2, 4, 8):
            raise ValueError(
                f"{type(self).__name__}: weight_bits must be 2, 4, or 8, "
                f"got {self.weight_bits}"
            )
        if self.layers < 1:
            raise ValueError(
                f"{type(self).__name__}: layers must be >= 1, got "
                f"{self.layers}"
            )
        if self.page_tokens < 0:
            raise ValueError(
                f"{type(self).__name__}: page_tokens must be >= 0, got "
                f"{self.page_tokens}"
            )
        if (self.page_tokens or self.page_tables is not None) \
                and not self._PAGED:
            raise ValueError(
                f"{type(self).__name__} has no paged stationary operands; "
                f"page_tokens/page_tables apply to the serve specs only"
            )
        if self.page_tables is not None and not self.page_tokens:
            raise ValueError(
                f"{type(self).__name__}: page_tables given without "
                f"page_tokens"
            )

    def _finish(self, prog: Program) -> Program:
        """Apply the spec's ``tag`` suffix (if any) and validate."""
        if self.tag:
            prog = Program.merge([prog], tags=[self.tag])
        prog.validate()
        return prog


@dataclasses.dataclass(frozen=True, kw_only=True)
class AttentionLoweringSpec(LoweringSpec):
    """One prefill attention block (:func:`lower_attention` front door).

    ``split_qkv`` is the normalized home of the old keyword flag: three
    independent q/k/v projection stages instead of the fused qkv stage.
    """

    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    hidden: int = 0
    seq_len: int = 0
    name: str = "attention"
    x: Optional[np.ndarray] = None
    split_qkv: bool = False

    def __post_init__(self) -> None:
        super().__post_init__()
        for field in ("heads", "kv_heads", "head_dim", "hidden", "seq_len"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"AttentionLoweringSpec: {field} must be >= 1, got "
                    f"{getattr(self, field)}"
                )
        if self.heads % self.kv_heads:
            raise ValueError(
                f"AttentionLoweringSpec: heads={self.heads} not divisible "
                f"by kv_heads={self.kv_heads}"
            )

    def attention_spec(self) -> AttentionSpec:
        return AttentionSpec(
            name=self.name, layers=self.layers, hidden=self.hidden,
            heads=self.heads, kv_heads=self.kv_heads,
            head_dim=self.head_dim, seq_len=self.seq_len,
            weight_bits=self.weight_bits,
        )


def _check_serve_attention(spec: "LoweringSpec", contexts: Tuple[int, ...],
                           m: int) -> None:
    """Shared construction-time checks for the serve spec family."""
    if contexts:
        if not (spec.heads and spec.kv_heads and spec.head_dim):
            raise ValueError(
                f"{type(spec).__name__}: attention lowering needs "
                f"heads/kv_heads/head_dim"
            )
        if spec.heads % spec.kv_heads:
            raise ValueError(
                f"{type(spec).__name__}: heads={spec.heads} not divisible "
                f"by kv_heads={spec.kv_heads}"
            )
        if m % len(contexts):
            raise ValueError(
                f"{type(spec).__name__}: {m} step rows cannot split over "
                f"{len(contexts)} slots"
            )


@dataclasses.dataclass(frozen=True, kw_only=True)
class ServeStepSpec(LoweringSpec):
    """One serving step (:func:`lower_serve_step` front door).

    ``explicit_layers`` and ``operands`` are the normalized homes of the
    old keyword flags; ``projections`` are the serve backend's
    ``(workload, weights)`` ProjectionOp records.  The spec's own
    ``weight_bits``/``seed`` fields: precision rides the projection
    workloads; ``seed`` seeds the synthesized KV caches.
    """

    projections: Sequence[Any] = ()
    m: int = 0
    contexts: Sequence[int] = ()
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    explicit_layers: int = 1
    operands: bool = True

    _PAGED = True

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.projections:
            raise ValueError("ServeStepSpec needs projection ops")
        if self.m < 1:
            raise ValueError(f"ServeStepSpec: m must be >= 1, got {self.m}")
        if self.explicit_layers < 1:
            raise ValueError(
                f"ServeStepSpec: explicit_layers must be >= 1, got "
                f"{self.explicit_layers}"
            )
        _check_serve_attention(self, tuple(self.contexts), self.m)


@dataclasses.dataclass(frozen=True, kw_only=True)
class ServeBatchSpec(LoweringSpec):
    """One decode step's merged batch graph (:func:`lower_serve_batch`)."""

    projections: Sequence[Any] = ()
    contexts: Sequence[int] = ()
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    rows_per_slot: int = 1
    explicit_layers: int = 1

    _PAGED = True

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.projections:
            raise ValueError("ServeBatchSpec needs projection ops")
        if not self.contexts:
            raise ValueError("ServeBatchSpec needs at least one slot "
                             "context")
        if self.rows_per_slot < 1:
            raise ValueError(
                f"ServeBatchSpec: rows_per_slot must be >= 1, got "
                f"{self.rows_per_slot}"
            )
        _check_serve_attention(
            self, tuple(self.contexts),
            len(self.contexts) * self.rows_per_slot,
        )


@dataclasses.dataclass(frozen=True, kw_only=True)
class ServeMixedSpec(LoweringSpec):
    """One mixed-phase engine step (:func:`lower_serve_mixed`)."""

    projections: Sequence[Any] = ()
    chunks: Sequence[Tuple[int, int]] = ()
    decode_contexts: Sequence[int] = ()
    heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0
    operands: bool = True
    chunk_page_tables: Optional[Sequence[Sequence[int]]] = None
    decode_page_tables: Optional[Sequence[Sequence[int]]] = None

    _PAGED = True

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.projections:
            raise ValueError("ServeMixedSpec needs projection ops")
        if not self.chunks and not self.decode_contexts:
            raise ValueError(
                "ServeMixedSpec needs at least one prefill chunk or decode "
                "slot"
            )
        for rows, t in self.chunks:
            if rows < 1 or t < rows:
                raise ValueError(
                    f"ServeMixedSpec: chunk ({rows}, {t}) needs rows >= 1 "
                    f"and context >= rows"
                )
        if (self.chunk_page_tables is not None
                or self.decode_page_tables is not None) \
                and not self.page_tokens:
            raise ValueError(
                "ServeMixedSpec: per-phase page tables given without "
                "page_tokens"
            )


@dataclasses.dataclass(frozen=True, kw_only=True)
class MoESpec(LoweringSpec):
    """A token-choice MoE FFN block for :func:`lower_moe`.

    ``tokens`` rows route over ``n_experts`` experts, ``top_k`` chosen per
    step.  ``chosen`` pins the routed expert set explicitly (exactly
    ``top_k`` distinct ids); by default the routing decision is derived
    from the lowered router GEMM's own logits (:meth:`routing`).
    """

    d_model: int = 0
    d_ff: int = 0
    n_experts: int = 0
    top_k: int = 0
    tokens: int = 0
    chosen: Optional[Tuple[int, ...]] = None
    name: str = "moe"

    def __post_init__(self) -> None:
        super().__post_init__()
        for field in ("d_model", "d_ff", "n_experts", "top_k", "tokens"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"MoESpec: {field} must be >= 1, got "
                    f"{getattr(self, field)}"
                )
        if self.top_k > self.n_experts:
            raise ValueError(
                f"MoESpec: top_k={self.top_k} > n_experts={self.n_experts}"
            )
        if self.chosen is not None:
            chosen = tuple(self.chosen)
            if len(set(chosen)) != len(chosen):
                raise ValueError(f"MoESpec: duplicate chosen ids {chosen}")
            if len(chosen) != self.top_k:
                raise ValueError(
                    f"MoESpec: {len(chosen)} chosen experts for "
                    f"top_k={self.top_k}"
                )
            if any(e < 0 or e >= self.n_experts for e in chosen):
                raise ValueError(
                    f"MoESpec: chosen ids {chosen} outside "
                    f"[0, {self.n_experts})"
                )

    # ------------------------------------------------------------------ #
    def operands(self) -> Dict[str, np.ndarray]:
        """Deterministic operand synthesis, independent of the routing
        decision — a k-of-E spec and its dense-E twin (``top_k ==
        n_experts``) share identical tokens and expert weights."""
        rng = np.random.default_rng(self.seed)
        d, f, e = self.d_model, self.d_ff, self.n_experts
        lo, hi = _WEIGHT_RANGES[self.weight_bits]
        return {
            "x": rng.integers(-8, 9, size=(self.tokens, d)).astype(np.int8),
            "router": rng.integers(-8, 9, size=(1, d, e)).astype(np.int8),
            "w1": rng.integers(lo, hi, size=(e, d, f)).astype(np.int8),
            "w3": rng.integers(lo, hi, size=(e, d, f)).astype(np.int8),
            "w2": rng.integers(lo, hi, size=(e, f, d)).astype(np.int8),
        }

    def routing(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(chosen, skipped) expert ids for this step.

        Step-granular top-k: router logits summed over the step's tokens,
        the ``top_k`` highest-scoring experts chosen (ties break to the
        lower id).  The expert-parallel view of ``models/moe.py``'s
        per-token routing — an expert with no routed tokens is a
        fully-sparse window.  ``chosen`` overrides the derivation.
        """
        if self.chosen is not None:
            chosen = tuple(sorted(self.chosen))
        else:
            ops = self.operands()
            logits = ops["x"].astype(np.int64) @ \
                ops["router"][0].astype(np.int64)
            score = logits.sum(axis=0)
            order = sorted(range(self.n_experts),
                           key=lambda e: (-score[e], e))
            chosen = tuple(sorted(order[:self.top_k]))
        skipped = tuple(e for e in range(self.n_experts) if e not in chosen)
        return chosen, skipped


@dataclasses.dataclass(frozen=True, kw_only=True)
class SSDSpec(LoweringSpec):
    """A Mamba-2 SSD scan segment for :func:`lower_ssd`.

    ``chunks`` chunks of ``chunk`` timesteps over ``heads`` heads with
    state width ``state`` and head dim ``head_dim`` — the ``kernels/ssd``
    geometry.  The scan is act-to-act int8 throughout, so
    ``weight_bits`` is pinned to 8 (the surrounding in/out projections
    are separate BitLinear stages, not part of the scan program).
    """

    heads: int = 0
    chunk: int = 0
    state: int = 0
    head_dim: int = 0
    chunks: int = 1
    name: str = "ssd"
    weight_bits: int = 8

    def __post_init__(self) -> None:
        super().__post_init__()
        for field in ("heads", "chunk", "state", "head_dim", "chunks"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"SSDSpec: {field} must be >= 1, got "
                    f"{getattr(self, field)}"
                )
        if self.weight_bits != 8:
            raise ValueError(
                f"SSDSpec: the SSD scan is int8 act-to-act; weight_bits "
                f"must be 8, got {self.weight_bits}"
            )


@dataclasses.dataclass(frozen=True, kw_only=True)
class HybridSpec(LoweringSpec):
    """A Zamba2-style hybrid period: one shared attention block sequenced
    before an SSD block (:func:`lower_hybrid`).  ``attention.layers``
    carries the shared block's application count, ``ssd.layers`` the SSM
    block count — the ``attn_every`` interleaving collapsed into the two
    sub-specs' layer multipliers."""

    attention: Optional[AttentionLoweringSpec] = None
    ssd: Optional[SSDSpec] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.attention is None or self.ssd is None:
            raise ValueError(
                "HybridSpec needs both an attention and an ssd sub-spec"
            )


# --------------------------------------------------------------------------- #
# MoE lowering
# --------------------------------------------------------------------------- #

def moe_stage_names(expert: int) -> Tuple[str, str]:
    """The (up, down) stage names of one expert's SwiGLU pair."""
    return f"{MLP_UP}[e{expert}]", f"{MLP_DOWN}[e{expert}]"


def lower_moe(spec: MoESpec) -> Program:
    """Lower a token-choice MoE FFN block to a Program.

    Graph: ``router`` (int8, all tokens) -> per expert ``e`` a SwiGLU
    pair ``mlp_up[e{e}]`` (w1 & w3, shared streamed tokens) ->
    ``mlp_down[e{e}]`` (consuming the combined gate*value).  Every
    expert's up stage carries an ``after`` control dependency on the
    router — expert execution waits on the routing decision — and the
    decision itself lowers to program-level sparsity: an unchosen
    expert's stages hold *zeroed* weights with ``ztb=True``, so the
    runtime's self-derived ZeroTileBooks gate every window (no stationary
    fetch, no activation stream, no psum — only the per-assignment drain
    remains, cross-validated against ``simulate()``'s full-skip limit at
    exactly 0%).  The k-of-E step's measured weight traffic therefore
    equals the dense-E step's minus the skipped experts' stationary
    bytes, and outputs stay bit-exact against the dense NumPy reference
    (zero weights -> zero outputs on both sides).
    """
    ops = spec.operands()
    chosen, _ = spec.routing()
    chosen_set = set(chosen)
    router_wl, up_wl, down_wl = moe_ffn_workloads(
        tokens=spec.tokens, d_model=spec.d_model, d_ff=spec.d_ff,
        n_experts=spec.n_experts, weight_bits=spec.weight_bits,
        layers=spec.layers,
    )
    prog = Program()
    prog.add(ProgramStage(name=ROUTER, workload=router_wl, x=ops["x"],
                          w=ops["router"]))
    for e in range(spec.n_experts):
        up_name, down_name = moe_stage_names(e)
        up_w = np.stack([ops["w1"][e], ops["w3"][e]])
        down_w = ops["w2"][e][None]
        skipped = e not in chosen_set
        if skipped:
            up_w = np.zeros_like(up_w)
            down_w = np.zeros_like(down_w)
        ztb = True if skipped else None
        prog.add(ProgramStage(
            name=up_name, workload=up_wl, x=ops["x"], w=up_w, ztb=ztb,
            after=(ROUTER,),
        ))
        prog.add(ProgramStage(
            name=down_name, workload=down_wl,
            x=Ref(up_name, swiglu_int8), w=down_w, ztb=ztb,
        ))
    return spec._finish(prog)


# --------------------------------------------------------------------------- #
# SSD lowering
# --------------------------------------------------------------------------- #

def ssd_stage_names(chunk: int) -> Tuple[str, str, str, str]:
    """The (score, intra, state, inter) stage names of one chunk (the
    inter name exists for chunks >= 1 only — chunk 0 has no prior state)."""
    return tuple(f"{s}[c{chunk}]" for s in
                 (SSD_SCORE, SSD_INTRA, SSD_STATE, SSD_INTER))


def lower_ssd(spec: SSDSpec) -> Program:
    """Lower a chunked Mamba-2 SSD scan segment to a Program.

    Per chunk ``c`` (``kernels/ssd``'s chunked decomposition, decays
    precomputed from a seeded per-head ``dt`` and folded into the
    inter-stage transforms):

    * ``ssd_score[c{c}]``  — ``C_c @ B_c^T`` (``[q,n] @ [n,q]``), computed
      ONCE per chunk: B/C are group-shared across heads in Mamba-2
      (``n_groups=1``), the same reuse ``ssd_grouped_scan`` exploits;
    * ``ssd_intra[c{c}]`` — ``(scores * decay_c) @ dtx_c`` per head
      (``[q,q] @ [q,p]``), the scores Ref'd from the score stage with the
      per-head causal decay mask applied in the transform;
    * ``ssd_state[c{c}]`` — ``(B_c * decay_out)^T @ dtx_c`` per head
      (``[n,q] @ [q,p]``): the chunk's contribution to the recurrent
      state;
    * ``ssd_inter[c{c}]`` (``c >= 1``) — ``(C_c * exp(la)) @ h_{c-1}``
      per head (``[q,n] @ [n,p]``), whose stationary operand is **the
      recurrent state as a cross-chunk Ref**: every earlier chunk's state
      stage feeds a multi-producer Ref whose transform applies the
      chunk-to-chunk decay products and requantizes — the graph-level
      image of ``h = exp(la_tot) * h + chunk_state``.

    The per-chunk output is ``y_c = intra_c + inter_c`` (host-side
    combine); within the program every stage is a plain int8 GEMM, so
    ``Machine.run`` reproduces ``reference_outputs`` bit for bit and each
    stage cross-validates against ``simulate()`` at 0%.
    """
    h, q, n, p, nc = (spec.heads, spec.chunk, spec.state, spec.head_dim,
                      spec.chunks)
    rng = np.random.default_rng(spec.seed)
    c_in = rng.integers(-8, 9, size=(nc, q, n)).astype(np.int8)   # C
    b_in = rng.integers(-8, 9, size=(nc, q, n)).astype(np.int8)   # B
    dtx = rng.integers(-8, 9, size=(h, nc, q, p)).astype(np.int8)
    dta = rng.uniform(0.02, 0.2, size=(h, nc, q))                 # dt * -A

    # decay precomputation — ssd_chunked_ref's la/seg/decay_out, A < 0
    la = np.cumsum(-dta, axis=-1)                    # [h, nc, q], decreasing
    ii = np.arange(q)[:, None]
    jj = np.arange(q)[None, :]
    seg = np.where(ii >= jj, la[..., :, None] - la[..., None, :], -np.inf)
    decay = np.exp(seg)                              # [h, nc, q, q] causal
    la_tot = la[..., -1]                             # [h, nc]
    decay_out = np.exp(la_tot[..., None] - la)       # [h, nc, q]

    score_w, intra_w, state_w, inter_w = ssd_chunk_workloads(
        heads=h, chunk=q, state=n, head_dim=p, layers=spec.layers,
    )

    prog = Program()
    state_names = []
    for c in range(nc):
        score_name, intra_name, state_name, inter_name = ssd_stage_names(c)

        # score: one group-shared GEMM per chunk (stationary B^T)
        prog.add(ProgramStage(
            name=score_name, workload=score_w,
            x=c_in[c], w=b_in[c].T.copy()[None], w_source=STATIONARY_ACT,
        ))

        # intra-chunk output: per-head decay mask folded into the Ref
        def masked_scores(out: np.ndarray, dc=decay[:, c]) -> np.ndarray:
            return requantize_int8(out[0].astype(np.float64)[None] * dc)

        prog.add(ProgramStage(
            name=intra_name, workload=intra_w,
            x=Ref(score_name, masked_scores),
            w=dtx[:, c], w_source=STATIONARY_ACT,
        ))

        # chunk state: (B_c * decay_out)^T per head, streamed
        bt = np.transpose(
            b_in[c].astype(np.float64)[None] * decay_out[:, c, :, None],
            (0, 2, 1),
        )
        prog.add(ProgramStage(
            name=state_name, workload=state_w,
            x=requantize_int8(bt), w=dtx[:, c], w_source=STATIONARY_ACT,
        ))

        # inter-chunk output: recurrent state stationary, Ref'd across
        # every earlier chunk's state stage through the decay recurrence
        if c > 0:
            def h_prev(*states: np.ndarray, c=c) -> np.ndarray:
                acc = np.zeros((h, n, p), np.float64)
                for j, st in enumerate(states):
                    factor = np.exp(la_tot[:, j + 1:c].sum(axis=1))
                    acc += st.astype(np.float64) * factor[:, None, None]
                return requantize_int8(acc)

            x_inter = requantize_int8(
                c_in[c].astype(np.float64)[None]
                * np.exp(la[:, c])[:, :, None]
            )
            prog.add(ProgramStage(
                name=inter_name, workload=inter_w, x=x_inter,
                w=Ref(tuple(state_names), h_prev),
                w_source=STATIONARY_ACT,
            ))
        state_names.append(state_name)
    return spec._finish(prog)


# --------------------------------------------------------------------------- #
# Hybrid lowering + the unified dispatcher
# --------------------------------------------------------------------------- #

def lower_hybrid(spec: HybridSpec) -> Program:
    """Lower one hybrid period: the shared attention block's program
    merged with the SSD block's, tagged ``{attn}`` / ``{ssm}``, with the
    Zamba2 sequencing (shared attention before the SSM blocks) expressed
    as control dependencies from the SSD graph's root stages onto the
    attention block's final stage."""
    attn_prog = lower(dataclasses.replace(spec.attention, tag=""))
    ssd_prog = lower(dataclasses.replace(spec.ssd, tag=""))
    attn_last = attn_prog.topo_order()[-1].name + "{attn}"
    merged = Program.merge([attn_prog, ssd_prog], tags=["{attn}", "{ssm}"])
    prog = Program()
    for st in merged:
        if st.name.endswith("{ssm}") and not st.deps:
            st = dataclasses.replace(st, after=(attn_last,))
        prog.add(st)
    return spec._finish(prog)


def lower(spec: LoweringSpec) -> Program:
    """THE lowering entry point: dispatch any :class:`LoweringSpec` to its
    lowering function.  ``lower_attention`` / ``lower_serve_step`` /
    ``lower_serve_batch`` / ``lower_serve_mixed`` / ``lower_moe`` /
    ``lower_ssd`` remain as thin aliases for existing call sites."""
    if isinstance(spec, AttentionLoweringSpec):
        prog = lower_attention(spec.attention_spec(), x=spec.x,
                               seed=spec.seed, split_qkv=spec.split_qkv)
        return spec._finish(prog)
    if isinstance(spec, ServeStepSpec):
        prog = lower_serve_step(
            spec.projections, m=spec.m, contexts=tuple(spec.contexts),
            heads=spec.heads, kv_heads=spec.kv_heads,
            head_dim=spec.head_dim, layers=spec.layers, seed=spec.seed,
            explicit_layers=spec.explicit_layers, operands=spec.operands,
            page_tokens=spec.page_tokens, page_tables=spec.page_tables,
        )
        return spec._finish(prog)
    if isinstance(spec, ServeBatchSpec):
        prog = lower_serve_batch(
            spec.projections, contexts=tuple(spec.contexts),
            heads=spec.heads, kv_heads=spec.kv_heads,
            head_dim=spec.head_dim, layers=spec.layers,
            rows_per_slot=spec.rows_per_slot, seed=spec.seed,
            explicit_layers=spec.explicit_layers,
            page_tokens=spec.page_tokens, page_tables=spec.page_tables,
        )
        return spec._finish(prog)
    if isinstance(spec, ServeMixedSpec):
        prog = lower_serve_mixed(
            spec.projections, chunks=tuple(spec.chunks),
            decode_contexts=tuple(spec.decode_contexts), heads=spec.heads,
            kv_heads=spec.kv_heads, head_dim=spec.head_dim,
            layers=spec.layers, seed=spec.seed, operands=spec.operands,
            page_tokens=spec.page_tokens,
            chunk_page_tables=spec.chunk_page_tables,
            decode_page_tables=spec.decode_page_tables,
        )
        return spec._finish(prog)
    if isinstance(spec, MoESpec):
        return lower_moe(spec)
    if isinstance(spec, SSDSpec):
        return lower_ssd(spec)
    if isinstance(spec, HybridSpec):
        return lower_hybrid(spec)
    raise TypeError(
        f"lower() takes a LoweringSpec, got {type(spec).__name__}"
    )


def zoo_spec(cfg, *, seq_len: int = 64, tokens: int = 16, chunks: int = 2,
             seed: int = 0) -> LoweringSpec:
    """A registry :class:`~repro_torch.configs.base.ModelConfig`'s workload-zoo
    spec — the family-appropriate block lowered for the CI matrix:

    * ``moe``    -> the MoE FFN block (:class:`MoESpec`, expert-skip ZTB);
    * ``ssm``    -> the chunked SSD scan (:class:`SSDSpec`);
    * ``hybrid`` -> shared attention + SSD period (:class:`HybridSpec`);
    * everything else (dense / encoder / vlm) -> the attention block
      (:class:`AttentionLoweringSpec`).

    Model-family knowledge lives with the models (the helpers in
    ``repro_torch.models.{moe,mamba2,hybrid}``); this wrapper only dispatches,
    so ``legion`` stays import-light until a zoo spec is actually built.
    """
    family = getattr(cfg, "family", "dense")
    if family == "moe":
        from repro_torch.models.moe import moe_lowering_spec
        return moe_lowering_spec(cfg, tokens=tokens, seed=seed)
    if family == "ssm":
        from repro_torch.models.mamba2 import ssd_lowering_spec
        return ssd_lowering_spec(cfg, chunks=chunks, seed=seed)
    if family == "hybrid":
        from repro_torch.models.hybrid import hybrid_lowering_spec
        return hybrid_lowering_spec(cfg, seq_len=seq_len, chunks=chunks,
                                    seed=seed)
    return AttentionLoweringSpec(
        heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim_,
        hidden=cfg.d_model, seq_len=seq_len, weight_bits=cfg.weight_bits,
        layers=cfg.layers, seed=seed, name=cfg.name,
    )
