"""`Machine` — the Legion runtime as a session facade (API redesign).

The paper's D-Legion is *one machine* with swappable concerns: precision
modes, psum accumulators, NoC multicast, Legion-level parallelism.  The repo
used to expose it as disconnected functions — ``execute_plan`` with eight
keyword options, hand-threaded ``TrafficTracer``/``CycleCounter`` objects at
every call site.  This module replaces that with a session object and two
protocols, in the style of serving engines that separate scheduling from
execution backends (vLLM's executor abstraction; TPUv4i's software-visible
core grouping):

* :class:`Instrument` — per-pass / per-fetch event hooks.
  :class:`~repro_torch.legion.trace.TrafficTracer` and
  :class:`~repro_torch.legion.latency.CycleCounter` implement it; registering an
  instrument replaces the old ``tracer=``/``cycles=`` kwarg threading.
  Per executed (K-window, N-tile) pass the event order is fixed and
  documented (see :class:`Instrument`), so third-party instruments have a
  spec to code against.

* :class:`ExecutorBackend` — owns the numerics of a prepared plan.
  :class:`InProcessExecutor` runs the classic window/kernel loop on the
  session's device: operands are uploaded once per plan, every tile GEMM
  launches the bitlinear CUDA kernel — or, for +ZTB modes at kernel
  granularity, the block-sparse kernel on a schedule built once per plan —
  (for CPU sessions, their plain versions) on strided views of them, and
  the int32 accumulator stays on the device until the stage ends.  At
  kernel granularity an integer stage without +ZTB launches the bitlinear
  kernel once, for all of its assignments' slices together.
  :class:`ShardedExecutor` spreads a plan's **Legion axis** over several
  devices, each shard's Legions as one grouped bitlinear launch at bits 8.

``Machine(cfg).run(plan_or_workload)`` returns a :class:`RunReport` merging
outputs, measured bytes, counted cycles, and (for workload runs) the
per-stage validation against ``simulate()`` — one object instead of four
hand-wired ones.

The unit of execution is the **stage graph**
(:class:`~repro_torch.legion.program.Program`): ``Machine.run(program)`` executes
the nodes in dependency order, threading inter-stage outputs through the
graph's refs (score -> softmax -> output) and firing stage-boundary
instrument events; legacy single-plan calls become one-node programs.
:class:`PipelinedExecutor` overlaps rounds of dependency-independent
stages — and prefetches a dependent stage's stationary tiles across the
boundary when they don't come from the outgoing stage — reporting
overlapped cycles that are always <= the serial per-stage sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (
    TYPE_CHECKING, Dict, Hashable, List, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.legion.program import Program, ProgramReport, ProgramStage

from repro_torch.core.config import AcceleratorConfig
from repro_torch.core.scheduler import Assignment, StagePlan, plan_stage
from repro_torch.core.simulator import simulate, simulate_workload
from repro_torch.core.sparsity import ZeroTileBook, ZTBStats
from repro_torch.core.workloads import GEMMWorkload, N_PARTITION
from repro_torch.device import DeviceLike, resolve_device
from repro_torch import kernels
from repro_torch.kernels import dense_tile_gemm
from repro_torch.kernels.bitlinear import ops as bl_ops
from repro_torch.kernels.bitlinear.ops import tile_gemm as bl_tile
from repro_torch.kernels.block_sparse import ops as bs_ops
from repro_torch.legion.latency import (
    CycleBreakdown,
    CycleCounter,
    CycleValidation,
    validate_mem_bw,
)
from repro_torch.legion.modes import (
    BITLINEAR,
    BLOCK_SPARSE,
    ModeSpec,
    select_mode,
)
from repro_torch.legion.trace import StageValidation, TrafficTotals, TrafficTracer
from repro_torch.quant.packing import pack_2bit_kmajor, pack_4bit_kmajor

GRANULARITIES = ("window", "kernel")
# "auto" = the kernels' own dispatch (CUDA kernel on the card, the plain
# version on the CPU); each must match the session's device
KERNEL_BACKENDS = ("auto", "reference", "cuda")


def resolve_kernel_backend(kernel_backend: str,
                           device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"reference"`` on the
    CPU; an explicit backend that does not match the device raises."""
    want = "cuda" if device.type == "cuda" else "reference"
    if kernel_backend == "auto":
        return want
    if kernel_backend != want:
        raise ValueError(
            f"kernel_backend={kernel_backend!r} cannot run on {device}: "
            f"CUDA devices launch the kernels, CPU runs the plain versions"
        )
    return kernel_backend


def validate_options(
    *,
    granularity: str = "window",
    kernel_backend: str = "auto",
    accumulators: Optional[int] = None,
) -> None:
    """Reject nonsensical execution options with clear messages.

    The single validation boundary for options the old ``execute_plan``
    silently accepted (``accumulators<=0`` produced empty bank groups — no
    compute, silently wrong outputs; unknown ``kernel_backend`` strings fell
    through to the kernels' default dispatch).
    """
    if granularity not in GRANULARITIES:
        raise ValueError(
            f"granularity={granularity!r}: expected one of {GRANULARITIES}"
        )
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"kernel_backend={kernel_backend!r}: expected one of "
            f"{KERNEL_BACKENDS}"
        )
    if accumulators is not None:
        if isinstance(accumulators, bool) \
                or not isinstance(accumulators, (int, np.integer)) \
                or accumulators <= 0:
            raise ValueError(
                "accumulators must be a positive int (parallel psum banks) "
                f"or None for the config default; got {accumulators!r}"
            )


# --------------------------------------------------------------------------- #
# Instrument protocol
# --------------------------------------------------------------------------- #

class Instrument:
    """Event hooks a run fires, in a fixed documented order.

    Every run executes a :class:`~repro_torch.legion.program.Program` (legacy
    single-plan calls become a one-node program), so the stream is:

    ``on_program_begin`` once, then **per stage in topological order**:

    * ``on_stage_begin`` — the stage boundary (node name, topological
      index, dependency names);
    * ``on_plan_begin`` once, then per assignment (sorted by (round,
      legion)) and per (K-window, N-tile) pass either

      - ``on_window_skip`` — the window is ZTB fully-sparse: no fetch, no
        psum round, no compute; or
      - ``on_weight_fetch`` -> ``on_act_stream`` -> ``on_psum`` ->
        ``on_pass`` — one executed pass (the tracer deduplicates repeated
        fetch keys itself; every event fires regardless),

      then ``on_assignment_end`` once per assignment, and ``on_plan_end``
      once;
    * ``on_stage_end`` — the stage's outputs are final (inter-stage
      threading resolves refs against them next);

    and ``on_program_end`` once with every stage's outputs.  Session
    instruments and caller-passed per-run instruments receive the whole
    stream; the per-stage fresh tracer/counter pair sees only its own
    stage's plan events.  Subclass and override what you need — every
    hook is a no-op — or duck-type: missing hooks are skipped.
    """

    def on_program_begin(self, program) -> None:
        """A validated Program is about to execute (once per run)."""

    def on_stage_begin(self, *, stage: str, index: int,
                       deps: Tuple[str, ...]) -> None:
        """A program stage is about to execute (topological order)."""

    def on_stage_end(self, *, stage: str, outputs: np.ndarray) -> None:
        """A program stage's ``[count, M, N]`` outputs are final."""

    def on_program_end(self, outputs: Dict[str, np.ndarray]) -> None:
        """The whole program finished; per-stage outputs by node name."""

    def on_plan_begin(self, plan: StagePlan, mode: ModeSpec,
                      ctx: "ExecContext") -> None:
        """A prepared plan is about to execute."""

    def on_page_fetch(self, key: Hashable, nbytes: float,
                      waste: float, *, stage: str, round_: int,
                      legion: int) -> None:
        """A KV-cache page moves (paged stationary operands only; fires at
        the start of an assignment, before its pass stream).  ``nbytes``
        is the whole fixed-size page, ``waste`` the last-page padding
        share of it.  Keys dedup like weight fetches (one multicast fetch
        per page per GQA group)."""

    def on_weight_fetch(self, key: Hashable, nbytes: float) -> None:
        """A stationary tile moves (key identifies the physical transfer)."""

    def on_act_stream(self, key: Hashable, nbytes: float) -> None:
        """An activation stream pass moves (key = broadcast identity)."""

    def on_psum(self, nbytes: float) -> None:
        """Psum bank traffic for one pass (write, or read-modify-write)."""

    def on_pass(self, *, stage: str, round_: int, legion: int, instance: int,
                k_tile: int, n_lo: int, n_hi: int) -> None:
        """One (K-window, N-tile) pass executed."""

    def on_window_skip(self, *, stage: str, round_: int, legion: int,
                       instance: int, k_tile: int, n_lo: int,
                       n_hi: int) -> None:
        """A ZTB fully-sparse window was skipped outright."""

    def on_assignment_end(self, *, stage: str, round_: int, legion: int,
                          instance: int, m: int, passes: int, skipped: int,
                          weight_bytes: float) -> None:
        """An assignment finished (CycleCounter's accounting granularity)."""

    def on_plan_end(self, outputs: np.ndarray) -> None:
        """The plan's outputs are final."""


def _each(instruments: Sequence[object], hook: str, *args, **kwargs) -> None:
    for ins in instruments:
        fn = getattr(ins, hook, None)
        if fn is not None:
            fn(*args, **kwargs)


# --------------------------------------------------------------------------- #
# Prepared execution context (operand prep shared by every backend)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class ExecContext:
    """One plan's operands + geometry, prepared once, executed by a backend.

    ``x_pad``, ``w_pad`` and ``packed`` live on ``device`` (uploaded once
    per plan); the ZTB books were built on the host from the same weights.
    """

    cfg: AcceleratorConfig
    plan: StagePlan
    mode: ModeSpec
    x_pad: torch.Tensor
    w_pad: torch.Tensor
    count: int
    m: int
    k: int
    n: int
    k_window: int
    k_tiles: int
    n_tile: int
    int_path: bool
    banks: int
    granularity: str
    kernel_backend: str
    emulate_cores: bool
    multicast: bool
    broadcast_stream: bool
    clip_weight_tiles: bool
    wbytes: float
    abytes: float
    device: torch.device
    page_tokens: int = 0
    page_axis: str = ""
    books: Optional[List[ZeroTileBook]] = None
    # K-major packed weights, [count, K / f, N] or [K / f, N] when shared
    packed: Optional[torch.Tensor] = None
    # (instance, n_lo, n_hi) -> block-sparse kernel schedule (+ZTB modes at
    # kernel granularity)
    schedules: Optional[Dict[Tuple[int, int, int],
                             Tuple[torch.Tensor, torch.Tensor]]] = None

    @property
    def out_dtype(self) -> torch.dtype:
        return torch.int32 if self.int_path else torch.float32

    def ztb_stats(self) -> Optional[ZTBStats]:
        from repro_torch.legion.runtime import combined_ztb_stats
        return combined_ztb_stats(self.books) if self.books else None

    def tiles_for(self, a: Assignment) -> List[Tuple[int, int, int]]:
        """(slot j, n_lo, n_hi) accumulator tiles of one assignment."""
        tiles, lo, j = [], a.n_lo, 0
        while lo < a.n_hi:
            tiles.append((j, lo, min(lo + self.n_tile, a.n_hi)))
            lo += self.n_tile
            j += 1
        return tiles

    def window_skipped(self, book: Optional[ZeroTileBook], k_tile: int,
                       gtile: int) -> bool:
        if book is None:
            return False
        wn = book.window_nonzero
        return gtile < wn.shape[1] and not wn[k_tile, gtile]


def prepare_context(
    cfg: AcceleratorConfig,
    plan: StagePlan,
    x: np.ndarray,
    w: np.ndarray,
    *,
    mode: Optional[ModeSpec] = None,
    ztb: Union[None, bool, ZeroTileBook, Sequence[ZeroTileBook]] = None,
    granularity: str = "window",
    kernel_backend: str = "auto",
    emulate_cores: bool = False,
    accumulators: Optional[int] = None,
    device: DeviceLike = None,
) -> ExecContext:
    """Validate a plan + operands and prepare everything backends share:
    K-padding, ZTB books, sub-byte packing, traffic geometry — and upload
    the padded operands and packed weights to ``device`` once."""
    from repro_torch.legion.runtime import (
        _build_books, _pad_axis, validate_coverage,
    )

    validate_options(granularity=granularity, kernel_backend=kernel_backend,
                     accumulators=accumulators)
    device = resolve_device(device)
    kernel_backend = resolve_kernel_backend(kernel_backend, device)
    x = np.asarray(x)
    w = np.asarray(w)
    if not plan.assignments:
        raise ValueError(f"plan {plan.stage!r} has no assignments")
    count = max(a.instance for a in plan.assignments) + 1
    m, k = x.shape[-2], x.shape[-1]
    n = w.shape[-1]
    if w.shape[-2] != k:
        raise ValueError(f"x K={k} vs w K={w.shape[-2]}")
    validate_coverage(plan, n=n, count=count)

    if mode is None:
        mode = select_mode(cfg, plan.weight_bits,
                           sparse=ztb not in (None, False))

    a0 = plan.assignments[0]
    k_window = a0.k_window or cfg.cores * cfg.d
    k_tiles = a0.k_tiles if a0.k_window else max(math.ceil(k / k_window), 1)
    k_pad = k_tiles * k_window
    n_tile = mode.n_tile(cfg.d)

    x_pad = _pad_axis(x, x.ndim - 1, k_pad)
    w_pad = _pad_axis(w, w.ndim - 2, k_pad)

    books: Optional[List[ZeroTileBook]] = None
    if ztb is True:
        books = _build_books(w_pad, count, cfg, mode)
    elif isinstance(ztb, ZeroTileBook):
        books = [ztb] * count
    elif ztb not in (None, False):
        books = list(ztb)
        if len(books) != count:
            raise ValueError(f"{len(books)} books for {count} instances")

    int_path = (np.issubdtype(x.dtype, np.integer)
                and np.issubdtype(w.dtype, np.integer))
    if mode.backend == BITLINEAR:
        # the bitlinear kernel streams int8 activations (the reference
        # casts every tile; casting once at upload is the same values)
        x_pad = x_pad.astype(np.int8)
    elif mode.backend == BLOCK_SPARSE and not int_path:
        # the reference multiplies +ZTB float tiles in float32
        x_pad = x_pad.astype(np.float32)
        w_pad = w_pad.astype(np.float32)
    x_dev = torch.from_numpy(np.ascontiguousarray(x_pad)).to(device)
    w_dev = torch.from_numpy(np.ascontiguousarray(w_pad)).to(device)

    schedules = None
    if mode.backend == BLOCK_SPARSE and granularity == "kernel":
        schedules = _block_schedules(plan, w_pad, k_window, device)

    packed: Optional[torch.Tensor] = None
    if mode.backend == BITLINEAR:
        factor = 8 // mode.weight_bits
        if k_window % factor or cfg.d % factor:
            raise ValueError(
                f"K window {k_window} / D {cfg.d} not divisible by packing "
                f"factor {factor}"
            )
        pack = pack_2bit_kmajor if mode.weight_bits == 2 else pack_4bit_kmajor
        if w_dev.ndim == 2:
            packed = pack(w_dev.to(torch.int8))      # shared by every instance
        else:
            packed = torch.stack([pack(w_dev[i].to(torch.int8))
                                  for i in range(count)])

    # units==1: no NoC — every instance refetches its stationary tiles and
    # streams privately; padded-tile accounting matches the analytic model.
    multicast = cfg.units > 1
    # One activation broadcast can only serve several Legions when they
    # consume the *same* data: a shared input matrix (x is [M, K]) or an
    # N-partitioned instance (all Legions slice one GEMM).
    broadcast_stream = multicast and (
        x.ndim == 2 or plan.mapping == N_PARTITION
    )
    # Stationary tiles move padded to the full R*D grid width, except under
    # multi-Legion N-partitioning where the memory controller clips the last
    # Legion's fetch to the matrix edge (the analytic model's cap).
    clip_weight_tiles = multicast and plan.mapping == N_PARTITION

    return ExecContext(
        cfg=cfg, plan=plan, mode=mode, x_pad=x_dev, w_pad=w_dev, count=count,
        m=m, k=k, n=n, k_window=k_window, k_tiles=k_tiles, n_tile=n_tile,
        int_path=int_path, banks=accumulators or cfg.accumulators,
        granularity=granularity, kernel_backend=kernel_backend,
        emulate_cores=emulate_cores, multicast=multicast,
        broadcast_stream=broadcast_stream,
        clip_weight_tiles=clip_weight_tiles,
        wbytes=mode.weight_bytes_per_element(cfg), abytes=cfg.dtype_bytes,
        device=device, page_tokens=plan.page_tokens,
        page_axis=plan.page_axis, books=books, packed=packed,
        schedules=schedules,
    )


def _block_schedules(
    plan: StagePlan, w_pad: np.ndarray, k_window: int, device: torch.device,
) -> Dict[Tuple[int, int, int], Tuple[torch.Tensor, torch.Tensor]]:
    """The block-sparse kernel's schedules of a +ZTB plan, built on the
    host once per plan and uploaded: one per (instance, n_lo, n_hi) slice
    an assignment launches, since slices need not line up with the
    kernel's ``KERNEL_BN`` columns.  Blocks are ``k_window`` x
    ``KERNEL_BN`` and come from ``w``'s own zeros, as the reference's
    ``tile_gemm`` derives them (caller books do not enter)."""
    from repro_torch.legion.runtime import _instance_view

    out = {}
    for a in plan.assignments:
        key = (a.instance, a.n_lo, a.n_hi)
        if key not in out:
            ws = _instance_view(w_pad, a.instance, 2)[:, a.n_lo:a.n_hi]
            out[key] = bs_ops.schedule(
                bs_ops.block_mask(ws, bk=k_window, bn=bs_ops.KERNEL_BN),
                device)
    return out


# --------------------------------------------------------------------------- #
# The window/kernel loop (events always; numerics when compute=True)
# --------------------------------------------------------------------------- #

def _gemm(ctx: ExecContext, xs: torch.Tensor, inst: int, k_lo: int,
          k_hi: int, c_lo: int, c_hi: int,
          acc: torch.Tensor) -> None:
    """One tile GEMM added into ``acc``: x rows [*, k_lo:k_hi] @
    w[k_lo:k_hi, c_lo:c_hi].  Strided views go to the kernel uncopied.

    Integer paths accumulate in place (exact in any order); the float path
    adds the finished product, in the reference's order.
    """
    from repro_torch.legion.runtime import _instance_view

    if ctx.mode.backend == BITLINEAR:
        factor = 8 // ctx.mode.weight_bits
        packed = _instance_view(ctx.packed, inst, 2)
        wp = packed[k_lo // factor:k_hi // factor, c_lo:c_hi]
        bl_tile(xs[:, k_lo:k_hi], wp, bits=ctx.mode.weight_bits,
                backend=ctx.kernel_backend, out=acc)
        return
    ws = _instance_view(ctx.w_pad, inst, 2)[k_lo:k_hi, c_lo:c_hi]
    if ctx.int_path:
        dense_tile_gemm(xs[:, k_lo:k_hi], ws, backend=ctx.kernel_backend,
                        out=acc)
    else:
        acc += dense_tile_gemm(xs[:, k_lo:k_hi], ws,
                               backend=ctx.kernel_backend)


def _kernel_call(ctx: ExecContext, xs: torch.Tensor, inst: int, lo: int,
                 hi: int, acc: torch.Tensor) -> None:
    """Whole-slice kernel dispatch added into ``acc``: +ZTB modes launch
    the block-sparse kernel on the slice's prebuilt schedule, the others
    one tile GEMM over the whole K range."""
    from repro_torch.legion.runtime import _instance_view

    if ctx.mode.backend != BLOCK_SPARSE:
        _gemm(ctx, xs, inst, 0, xs.shape[-1], lo, hi, acc)
        return
    indices, counts = ctx.schedules[(inst, lo, hi)]
    ws = _instance_view(ctx.w_pad, inst, 2)[:, lo:hi]
    bs_ops.block_sparse_matmul(xs, ws, indices, counts, bk=ctx.k_window,
                               bn=bs_ops.KERNEL_BN,
                               backend=ctx.kernel_backend, out=acc)


def _grouped_call(ctx: ExecContext, slices: List[Tuple[int, int, int]],
                  out: torch.Tensor) -> None:
    """Every whole-slice product of an integer stage, one per
    ``(instance, n_lo, n_hi)`` of ``slices``, added into ``out`` as one
    grouped launch of the bitlinear kernel (its plain version on the CPU):
    packed weights at the mode's bits, dense integer weights at bits 8."""
    if ctx.mode.backend == BITLINEAR:
        bl_ops.grouped_tile_gemm(ctx.x_pad, ctx.packed, out, slices,
                                 bits=ctx.mode.weight_bits,
                                 backend=ctx.kernel_backend)
    else:
        kernels.dense_grouped_tile_gemm(ctx.x_pad, ctx.w_pad, out, slices,
                                        backend=ctx.kernel_backend)


def _window_partial(ctx: ExecContext, xs: torch.Tensor, a: Assignment,
                    book: Optional[ZeroTileBook], i: int, gtile: int,
                    lo: int, hi: int, acc: torch.Tensor) -> None:
    """One (K-window, N-tile) pass added into ``acc``."""
    if not ctx.emulate_cores:
        _gemm(ctx, xs, a.instance, i * ctx.k_window, (i + 1) * ctx.k_window,
              lo, hi, acc)
        return
    # per-core partials; the float path sums them before the add, as the
    # reference does
    partial = acc if ctx.int_path else torch.zeros_like(acc)
    for c in range(ctx.cfg.cores):
        if book is not None and gtile < book.tile_nonzero.shape[2] \
                and not book.tile_nonzero[i, c, gtile]:
            continue   # gated core (zero tile)
        k_lo = i * ctx.k_window + c * ctx.cfg.d
        _gemm(ctx, xs, a.instance, k_lo, k_lo + ctx.cfg.d, lo, hi, partial)
    if partial is not acc:
        acc += partial


def run_assignment_loop(
    ctx: ExecContext, instruments: Sequence[object], *, compute: bool = True,
) -> Optional[np.ndarray]:
    """Walk every assignment's psum-accumulator loop, firing instrument
    events; with ``compute`` the numerics run too.

    The ``[count, M, N]`` accumulator lives on ``ctx.device``; every tile
    GEMM adds into a view of it, and it comes back to the host once, as
    the returned numpy array.
    """
    from repro_torch.legion.runtime import _instance_view

    plan = ctx.plan
    out = None
    if compute:
        out = torch.zeros((ctx.count, ctx.m, ctx.n), dtype=ctx.out_dtype,
                          device=ctx.device)
    # kernel granularity on an integer path without +ZTB: the stage's
    # whole-slice products go out as one grouped launch after the loop
    grouped = (compute and ctx.granularity == "kernel" and ctx.int_path
               and ctx.mode.backend != BLOCK_SPARSE)
    slices: List[Tuple[int, int, int]] = []
    for a in sorted(plan.assignments, key=lambda a: (a.round, a.legion)):
        inst = a.instance
        xs = _instance_view(ctx.x_pad, inst, 2)
        book = ctx.books[inst] if ctx.books else None
        wkey = (a.multicast_group if ctx.multicast else ("inst", inst))
        tiles = ctx.tiles_for(a)
        a_exec = 0           # executed (K-window, N-tile) passes
        a_skip = 0           # ZTB fully-sparse windows skipped outright
        a_wbytes = 0.0       # stationary bytes the passes fetched

        if ctx.page_tokens and ctx.page_axis:
            # Paged stationary KV: the assignment touches every page whose
            # token span intersects its slice of the token axis (N for
            # attn_score's K^T, the whole K axis for attn_output's V).
            # Page keys dedup like weight keys — one multicast fetch per
            # page per GQA group — so totals count ceil(t/P) whole pages
            # per distinct KV matrix; the last page's padding beyond the
            # logical token count is the measured page-boundary waste.
            # Fired before the pass stream (assignment-clean state), and
            # ignored by CycleCounter: page granularity reshapes traffic,
            # never serial cycles.
            p_sz = ctx.page_tokens
            if ctx.page_axis == "n":
                tok_lo, tok_hi, tok_total = a.n_lo, a.n_hi, ctx.n
                per_tok = ctx.k          # K^T column: K elems per token
            else:
                tok_lo, tok_hi, tok_total = 0, ctx.k, ctx.k
                per_tok = ctx.n          # V row: N elems per token
            page_nbytes = p_sz * per_tok * ctx.wbytes
            for p in range(tok_lo // p_sz, -(-tok_hi // p_sz)):
                waste_toks = max((p + 1) * p_sz - tok_total, 0)
                _each(instruments, "on_page_fetch",
                      ("p", plan.stage, wkey, p), page_nbytes,
                      waste_toks * per_tok * ctx.wbytes,
                      stage=plan.stage, round_=a.round, legion=a.legion)

        # Tiles are served by `banks` parallel accumulators: process them in
        # bank-sized groups (numerically associative — ordering only).
        for g in range(0, len(tiles), ctx.banks):
            for (j, lo, hi) in tiles[g:g + ctx.banks]:
                gtile = lo // ctx.n_tile   # global N-tile id (book column)
                executed = 0
                for i in range(ctx.k_tiles):
                    if ctx.window_skipped(book, i, gtile):
                        a_skip += 1
                        _each(instruments, "on_window_skip",
                              stage=plan.stage, round_=a.round,
                              legion=a.legion, instance=inst, k_tile=i,
                              n_lo=lo, n_hi=hi)
                        continue          # fully-sparse window: skip outright
                    if compute and ctx.granularity == "window":
                        _window_partial(ctx, xs, a, book, i, gtile, lo, hi,
                                        out[inst, :, lo:hi])
                    # ---- traffic events (identical per granularity) ------ #
                    width = (hi - lo) if ctx.clip_weight_tiles else ctx.n_tile
                    nbytes_w = ctx.k_window * width * ctx.wbytes
                    _each(instruments, "on_weight_fetch",
                          ("w", plan.stage, wkey, i, lo), nbytes_w)
                    akey_owner = (a.round if ctx.broadcast_stream
                                  else ("inst", inst))
                    _each(instruments, "on_act_stream",
                          ("a", plan.stage, akey_owner, j, i),
                          ctx.m * ctx.k_window * ctx.abytes)
                    psum = (hi - lo) * ctx.m * 4.0
                    _each(instruments, "on_psum",
                          psum if executed == 0 else 2.0 * psum)
                    _each(instruments, "on_pass", stage=plan.stage,
                          round_=a.round, legion=a.legion, instance=inst,
                          k_tile=i, n_lo=lo, n_hi=hi)
                    executed += 1
                    a_exec += 1
                    a_wbytes += nbytes_w

        _each(instruments, "on_assignment_end", stage=plan.stage,
              round_=a.round, legion=a.legion, instance=inst, m=ctx.m,
              passes=a_exec, skipped=a_skip, weight_bytes=a_wbytes)

        if grouped:
            slices.append((inst, a.n_lo, a.n_hi))
        elif compute and ctx.granularity == "kernel":
            # whole-slice dispatch: one kernel launch per assignment
            _kernel_call(ctx, xs, inst, a.n_lo, a.n_hi,
                         out[inst, :, a.n_lo:a.n_hi])
    if slices:
        _grouped_call(ctx, slices, out)
    return out.cpu().numpy() if compute else None


# --------------------------------------------------------------------------- #
# Executor backends
# --------------------------------------------------------------------------- #

class ExecutorBackend:
    """Owns the numerics of a prepared :class:`ExecContext`.

    ``execute`` must fire the full instrument event stream (via
    :func:`run_assignment_loop`) and return ``[count, M, N]`` outputs.
    """

    name = "abstract"

    def execute(self, ctx: ExecContext,
                instruments: Sequence[object]) -> np.ndarray:
        raise NotImplementedError


class InProcessExecutor(ExecutorBackend):
    """The classic single-process window/kernel loop (the session's device
    runs the tile GEMMs; the host walks the plan and fires the events)."""

    name = "in-process"

    def execute(self, ctx: ExecContext,
                instruments: Sequence[object]) -> np.ndarray:
        return run_assignment_loop(ctx, instruments, compute=True)


class ShardedExecutor(ExecutorBackend):
    """Executes a plan's Legion axis device-parallel.

    The port of the JAX package's ``ShardedExecutor``: assignments are
    grouped per Legion in ``(round, legion)`` order, and the Legion axis
    is spread over ``nshard = min(len(devices), len(legions))`` devices
    by :func:`repro_torch.distributed.sharding.legion_rules` (every other
    axis local), each shard holding ``l_pad / nshard`` Legions of up to
    ``rmax`` round slots, as the JAX executor stacks them.  Each shard's
    ``[l, r, M, K] @ [l, r, K, N]`` integer product (or a shared ``[M, K]``
    x) runs as one grouped bitlinear launch at bits 8 on its device
    (:func:`repro_torch.kernels.dense_grouped_tile_gemm`), the plain
    version on a CPU device; a shard whose Legions are all padding has
    nothing to multiply and launches nothing.  Integer accumulation is
    associative, so outputs are **bit-exact** with
    :class:`InProcessExecutor`; ZTB-gated windows are zeroed in the
    shard's copy of the weights, reproducing the skip semantics.

    Instrument events (traffic/cycles) come from the same shared walk as
    the in-process path (``run_assignment_loop(..., compute=False)``), so
    cross-validation against ``simulate()`` is backend-independent.

    ``devices`` are the shards' devices (``["cpu"] * 4`` runs four shards
    on the CPU); ``None`` is every CUDA device and raises without a card.
    Where the JAX executor refuses any ``kernel_backend`` but "reference"
    (its product is one XLA matmul, not the tile kernels), here the
    product *is* the kernel: the session's resolved kernel backend must be
    the one every shard's device takes ("cuda" for a CUDA device,
    "reference" for the CPU), so a kernel is never traded for its plain
    version (ROADMAP.md, Queue 3, port note 12).
    """

    name = "sharded"

    def __init__(self, *, devices: Optional[Sequence[DeviceLike]] = None,
                 axis: str = "legion") -> None:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available for ShardedExecutor(); "
                    "pass devices=['cpu', ...] to shard on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("ShardedExecutor needs at least one device")
        self.axis = axis
        self.devices_used = 0      # set per execute()

    # ------------------------------------------------------------------ #
    def execute(self, ctx: ExecContext,
                instruments: Sequence[object]) -> np.ndarray:
        if ctx.granularity != "window":
            raise ValueError(
                "ShardedExecutor executes the window (psum accumulator) "
                f"loop only; granularity={ctx.granularity!r}"
            )
        if not ctx.int_path:
            raise ValueError(
                "ShardedExecutor guarantees bit-exactness via associative "
                "int32 accumulation; float operands need InProcessExecutor"
            )
        if ctx.emulate_cores and ctx.books:
            raise ValueError(
                "ShardedExecutor cannot reproduce per-core ZTB gating "
                "(emulate_cores with ZeroTileBooks may exclude non-zero "
                "tiles); use InProcessExecutor"
            )
        for dev in self.devices:
            want = "cuda" if dev.type == "cuda" else "reference"
            if ctx.kernel_backend != want:
                raise ValueError(
                    f"ShardedExecutor runs each shard's product on its own "
                    f"device: {dev} takes kernel_backend={want!r}, the "
                    f"session resolved {ctx.kernel_backend!r}"
                )
        # accounting walk: the same event stream as the in-process path
        run_assignment_loop(ctx, instruments, compute=False)
        return self._compute(ctx)

    # ------------------------------------------------------------------ #
    def _compute(self, ctx: ExecContext) -> np.ndarray:
        from repro_torch.distributed.sharding import legion_rules
        from repro_torch.launch.mesh import abstract_mesh
        from repro_torch.legion.runtime import _instance_view

        per_legion: Dict[int, List[Assignment]] = {}
        for a in sorted(ctx.plan.assignments, key=lambda a: (a.round,
                                                             a.legion)):
            per_legion.setdefault(a.legion, []).append(a)
        legions = sorted(per_legion)
        nshard = max(min(len(self.devices), len(legions)), 1)
        l_pad = math.ceil(len(legions) / nshard) * nshard
        rmax = max(len(v) for v in per_legion.values())
        width = max(a.n_hi - a.n_lo for a in ctx.plan.assignments)
        k_pad = ctx.k_tiles * ctx.k_window
        rules = legion_rules(abstract_mesh((nshard,), (self.axis,)),
                             axis=self.axis)
        if rules.spec("legion", "round", "m", "k")[0] != self.axis:
            raise AssertionError(f"legion rules {rules.table}")
        per = l_pad // nshard             # Legions of one shard
        shared_x = ctx.x_pad.ndim == 2
        # the packed modes' integer weights fit int8, the kernel's type
        w_dtype = (torch.int8 if ctx.mode.backend == BITLINEAR
                   else ctx.w_pad.dtype)

        accs = []
        for d in range(nshard):
            dev = self.devices[d]
            mine = legions[d * per:(d + 1) * per]
            slots = [(li * rmax + slot, a)
                     for li, leg in enumerate(mine)
                     for slot, a in enumerate(per_legion[leg])]
            # a shared input matrix broadcasts to every (legion, slot)
            # inside the grouped product: one copy a shard
            xs = (ctx.x_pad.to(dev) if shared_x else torch.zeros(
                (per * rmax, ctx.m, k_pad), dtype=ctx.x_pad.dtype,
                device=dev))
            ws = torch.zeros((per * rmax, k_pad, width), dtype=w_dtype,
                             device=dev)
            for i, a in slots:
                if not shared_x:
                    xs[i] = _instance_view(ctx.x_pad, a.instance, 2)
                wsl = ws[i, :, :a.n_hi - a.n_lo]
                wsl.copy_(_instance_view(ctx.w_pad, a.instance,
                                         2)[:, a.n_lo:a.n_hi])
                book = ctx.books[a.instance] if ctx.books else None
                if book is not None:
                    # reproduce the skip semantics exactly: a gated window
                    # contributes nothing, even if the caller's book gates
                    # tiles that are not actually zero
                    for (_j, lo, hi) in ctx.tiles_for(a):
                        gtile = lo // ctx.n_tile
                        for k in range(ctx.k_tiles):
                            if ctx.window_skipped(book, k, gtile):
                                wsl[k * ctx.k_window:(k + 1) * ctx.k_window,
                                    lo - a.n_lo:hi - a.n_lo] = 0
            acc = torch.zeros((per * rmax, ctx.m, width), dtype=torch.int32,
                              device=dev)
            if slots:
                kernels.dense_grouped_tile_gemm(
                    xs, ws, acc, [(i, 0, width) for i, _ in slots])
            accs.append((slots, acc))

        self.devices_used = nshard
        out = torch.zeros((ctx.count, ctx.m, ctx.n), dtype=torch.int32)
        for slots, acc in accs:
            host = acc.cpu()
            for i, a in slots:
                out[a.instance, :, a.n_lo:a.n_hi] = \
                    host[i, :, :a.n_hi - a.n_lo]
        return out.numpy()


class PipelinedExecutor(ExecutorBackend):
    """Overlaps rounds of dependency-independent program stages.

    Numerics delegate to an ``inner`` executor (default
    :class:`InProcessExecutor`) — the pipelining is a *timing* transformation:
    ``Machine.run(program)`` feeds every stage's per-round critical paths
    (:meth:`~repro_torch.legion.latency.CycleCounter.round_criticals`) into
    :func:`repro_torch.legion.program.compute_pipeline`, which interleaves
    rounds within each dependency level — and across level boundaries
    whose adjacent rounds have no dependency path (merged-batch slots,
    multi-layer programs) — hiding the incoming round's systolic fill +
    pipeline ramp under the outgoing round's streaming + drain.  Even a
    *dependent* boundary hides its fill when the incoming stationary
    operand doesn't come from the outgoing stage (cross-level weight
    prefetch — the tiles already exist in memory).
    The resulting :class:`~repro_torch.legion.program.PipelineReport` rides on
    the :class:`~repro_torch.legion.program.ProgramReport`; overlapped cycles
    are always <= the serial per-stage sum (exactly equal only when every
    boundary's stationary operand is produced by the outgoing stage),
    and the serial sum itself cross-validates against ``simulate()``.
    ``LegionServeBackend`` runs each decode step's merged batch graph
    through this model to report the engine-view overlapped latency.
    """

    name = "pipelined"

    def __init__(self, inner: Optional[ExecutorBackend] = None) -> None:
        self.inner = inner if inner is not None else InProcessExecutor()

    def execute(self, ctx: ExecContext,
                instruments: Sequence[object]) -> np.ndarray:
        return self.inner.execute(ctx, instruments)


# --------------------------------------------------------------------------- #
# RunReport
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class RunReport:
    """Everything one :meth:`Machine.run` produced, in one object."""

    outputs: np.ndarray               # [count, M, N] int32 (or float32)
    plan: StagePlan
    mode: ModeSpec
    backend: str                      # executor name that ran the numerics
    trace: Optional[TrafficTracer]
    cycles: Optional[CycleCounter]
    ztb_stats: Optional[ZTBStats] = None
    workload: Optional[GEMMWorkload] = None
    traffic_validation: Optional[StageValidation] = None
    cycle_validation: Optional[CycleValidation] = None

    @property
    def output(self) -> np.ndarray:
        """Single-instance convenience view."""
        if self.outputs.shape[0] != 1:
            raise ValueError(f"{self.outputs.shape[0]} instances; use "
                             f".outputs")
        return self.outputs[0]

    @property
    def traffic(self) -> Optional[TrafficTotals]:
        """Measured bytes of the ONE executed layer (the runtime convention:
        a workload executes a single layer numerically).  The validation
        fields hold the whole-model view — measured totals scaled by
        ``workload.layers`` against ``simulate()``'s per-model numbers;
        scale by ``workload.layers`` yourself for model-level bytes."""
        return self.trace.totals if self.trace is not None else None

    @property
    def total_cycles(self) -> int:
        """Counted cycles of the ONE executed layer (see :attr:`traffic`
        for the single-layer vs whole-model convention)."""
        return self.cycles.total_cycles if self.cycles is not None else 0

    @property
    def validations(self) -> List[object]:
        return [v for v in (self.traffic_validation, self.cycle_validation)
                if v is not None]

    @property
    def ok(self) -> bool:
        """All attached validations within tolerance (vacuously True)."""
        return all(v.ok for v in self.validations)

    def __str__(self) -> str:
        lines = [f"RunReport[{self.plan.stage}] mode={self.mode.name} "
                 f"backend={self.backend} outputs={self.outputs.shape}"]
        lines += [f"  {v}" for v in self.validations]
        return "\n".join(lines)


def _build_validations(
    stage: str, measured_traffic: TrafficTotals,
    measured_cycles: CycleBreakdown, sim, rtol: float,
) -> Tuple[StageValidation, CycleValidation]:
    """Measured totals vs one simulated stage (shared by ``Machine.run``
    and ``Machine.cross_validate``)."""
    return (
        StageValidation(
            stage=stage, measured=measured_traffic,
            analytic=TrafficTotals(
                weight_bytes=sim.weight_bytes, act_bytes=sim.act_bytes,
                psum_bytes=sim.psum_bytes,
                page_fetches=sim.page_fetches, page_bytes=sim.page_bytes,
                page_waste_bytes=sim.page_waste_bytes,
            ),
            rtol=rtol,
        ),
        CycleValidation(
            stage=stage, measured=measured_cycles.total,
            analytic=sim.cycles, rtol=rtol,
            measured_breakdown=measured_cycles.as_dict(),
            analytic_breakdown=sim.cycle_breakdown,
        ),
    )


# --------------------------------------------------------------------------- #
# Machine
# --------------------------------------------------------------------------- #

class Machine:
    """Session facade over the Legion runtime: one object owns mode
    selection, plan execution, and measurement.

        machine = Machine(dlegion())                      # on the card
        report = machine.run(workload)                    # RunReport
        machine = Machine(cfg, device="cpu")              # plain versions
        machine = Machine(cfg, instruments=[my_probe])    # custom hooks

    Every run attaches a fresh :class:`TrafficTracer` + :class:`CycleCounter`
    (unless per-run ``instruments`` are given) plus the machine's registered
    instruments, so ``report.traffic``/``report.cycles`` are per-run while
    registered instruments observe the whole session.

    ``metrics=`` (optional, e.g. :class:`repro_torch.obs.metrics
    .MetricsRegistry`) additionally accumulates session-level ``machine_*``
    counters — stage runs, cycles, passes, measured bytes, pipeline
    speedups — as runs execute.

    ``device`` (default: the CUDA card; ``"cpu"`` must be asked for) is
    where the tile GEMMs run; ``kernel_backend="auto"`` resolves to the
    CUDA kernels there and to their plain versions on the CPU.
    """

    def __init__(
        self,
        cfg: AcceleratorConfig,
        *,
        backend: Optional[ExecutorBackend] = None,
        instruments: Optional[Sequence[object]] = None,
        granularity: str = "window",
        kernel_backend: str = "auto",
        emulate_cores: bool = False,
        accumulators: Optional[int] = None,
        mem_bw_bytes_per_cycle: float = math.inf,
        metrics: Optional[object] = None,
        device: DeviceLike = None,
    ) -> None:
        validate_options(granularity=granularity,
                         kernel_backend=kernel_backend,
                         accumulators=accumulators)
        mem_bw_bytes_per_cycle = validate_mem_bw(mem_bw_bytes_per_cycle)
        self.device = resolve_device(device)
        kernel_backend = resolve_kernel_backend(kernel_backend, self.device)
        self.cfg = cfg
        self.backend = backend if backend is not None else InProcessExecutor()
        self.instruments: List[object] = []
        self.granularity = granularity
        self.kernel_backend = kernel_backend
        self.emulate_cores = emulate_cores
        self.accumulators = accumulators
        self.mem_bw = mem_bw_bytes_per_cycle
        # Duck-typed metrics registry (see repro_torch.obs.metrics
        # .MetricsRegistry): anything with counter/gauge/histogram
        # get-or-create methods; None disables metric emission.
        self.metrics = metrics
        for inst in instruments or ():
            self.add_instrument(inst)

    # ------------------------------------------------------------------ #
    def add_instrument(self, instrument: object) -> object:
        """Register a session-lifetime instrument; returns it for chaining.

        Instruments that themselves model the machine (they expose ``cfg``
        / ``mem_bw`` attributes, e.g. :class:`repro_torch.obs.timeline
        .TimelineTracer`) silently drift if their model disagrees with the
        machine's, so registration reconciles them: an instrument
        constructed without an explicit config (``cfg is None``) inherits
        the machine's ``cfg``/``mem_bw``; one constructed *with* a config
        must match on both, else ``ValueError``.
        """
        if hasattr(instrument, "cfg") and hasattr(instrument, "mem_bw"):
            if instrument.cfg is None:
                instrument.cfg = self.cfg
                instrument.mem_bw = self.mem_bw
            elif (instrument.cfg != self.cfg
                  or instrument.mem_bw != self.mem_bw):
                raise ValueError(
                    f"instrument {type(instrument).__name__} models "
                    f"cfg={getattr(instrument.cfg, 'name', instrument.cfg)} "
                    f"@ mem_bw={instrument.mem_bw} but the machine runs "
                    f"cfg={self.cfg.name} @ mem_bw={self.mem_bw} — the "
                    "instrument would silently mis-model the run; construct "
                    "it with the machine's cfg/mem_bw (or neither, to "
                    "inherit them)"
                )
        self.instruments.append(instrument)
        return instrument

    # ------------------------------------------------------------------ #
    def run(
        self,
        work: Union[GEMMWorkload, StagePlan, "Program"],
        x: Optional[np.ndarray] = None,
        w: Optional[np.ndarray] = None,
        *,
        mode: Optional[ModeSpec] = None,
        ztb: Union[None, bool, ZeroTileBook, Sequence[ZeroTileBook]] = None,
        seed: int = 0,
        ztb_sparsity: float = 0.0,
        check_outputs: bool = True,
        validate: Optional[bool] = None,
        rtol: float = 0.05,
        instruments: Optional[Sequence[object]] = None,
    ) -> Union[RunReport, "ProgramReport"]:
        """Execute a :class:`~repro_torch.legion.program.Program`, a workload
        (planned + synthesized for you), or an explicit (plan, x, w)
        triple through the machine's backend.

        A Program run returns a :class:`~repro_torch.legion.program
        .ProgramReport` (per-stage RunReports in topological order,
        inter-stage outputs threaded through the graph's refs, plus a
        :class:`~repro_torch.legion.program.PipelineReport` under a
        :class:`PipelinedExecutor` backend).  Workload and plan calls are
        the thin single-node shim: they become a one-node program and
        return that node's :class:`RunReport`, exactly as before.

        Every stage checks outputs against the dense ``x @ w`` reference
        (bit-exact on the integer path, allclose on float) unless
        ``check_outputs=False`` or caller-supplied ZTB books gate the
        outputs away from the reference.  Workload stages additionally
        cross-validate measured traffic/cycles against ``simulate()``
        (``rtol``).  ``validate``: ``None`` (default) validates when the
        stage's measuring instruments are its own fresh pair and
        ``simulate()`` models the run; ``True`` requires validation
        (raises if the per-run instruments lack a tracer/counter, or the
        run has no analytic counterpart); ``False`` skips it.
        """
        from repro_torch.legion.program import Program

        if isinstance(work, Program):
            if x is not None or w is not None:
                raise ValueError(
                    "a Program carries its own operands; drop the x/w "
                    "arguments"
                )
            if mode is not None or ztb not in (None, False) or ztb_sparsity:
                raise ValueError(
                    "mode / ztb / ztb_sparsity are per-stage options; set "
                    "them on the ProgramStages"
                )
            return self.run_program(
                work, seed=seed, check_outputs=check_outputs,
                validate=validate, rtol=rtol, instruments=instruments,
            )
        program = Program.single(work, x, w, mode=mode, ztb=ztb,
                                 ztb_sparsity=ztb_sparsity)
        report = self.run_program(
            program, seed=seed, check_outputs=check_outputs,
            validate=validate, rtol=rtol, instruments=instruments,
        )
        return report.stage_reports[program.stages[0].name]

    # ------------------------------------------------------------------ #
    def run_program(
        self,
        program: "Program",
        *,
        seed: int = 0,
        check_outputs: bool = True,
        validate: Optional[bool] = None,
        rtol: float = 0.05,
        instruments: Optional[Sequence[object]] = None,
    ) -> "ProgramReport":
        """Execute every stage of ``program`` in topological order,
        threading inter-stage outputs through the graph's refs and firing
        the stage-boundary instrument events (see :class:`Instrument`).

        Under a :class:`PipelinedExecutor` backend the report additionally
        carries the overlapped-round :class:`~repro_torch.legion.program
        .PipelineReport` computed from each stage's per-round critical
        paths.
        """
        from repro_torch.legion.program import (
            ProgramReport, compute_pipeline,
        )

        program.validate()
        caller = list(instruments) if instruments is not None else None
        if validate and caller is not None and len(program) > 1:
            raise ValueError(
                "validate=True with caller-passed instruments cannot "
                "validate a multi-stage program per stage (the instruments' "
                "totals span stages); use the default per-stage instruments"
            )
        shared: List[object] = (caller or []) + self.instruments
        _each(shared, "on_program_begin", program)
        produced: Dict[str, np.ndarray] = {}
        reports: Dict[str, RunReport] = {}
        for idx, stage in enumerate(program.topo_order()):
            _each(shared, "on_stage_begin", stage=stage.name, index=idx,
                  deps=stage.deps)
            rep = self._run_stage(
                stage, produced, seed=seed, check_outputs=check_outputs,
                validate=validate, rtol=rtol, caller_instruments=caller,
                bind_caller=len(program) == 1,
            )
            produced[stage.name] = rep.outputs
            reports[stage.name] = rep
            _each(shared, "on_stage_end", stage=stage.name,
                  outputs=rep.outputs)

        pipeline = None
        # caller-passed instruments span the whole program — their cycle
        # cells mix every stage's rounds, so only the default per-stage
        # fresh counters can feed the overlap schedule
        if isinstance(self.backend, PipelinedExecutor) and caller is None:
            rounds: Optional[Dict[str, List[CycleBreakdown]]] = {}
            for name, rep in reports.items():
                if rep.cycles is None:
                    rounds = None    # no per-stage counters to schedule with
                    break
                rc = rep.cycles.round_criticals()
                rounds[name] = [b for key in sorted(rc) for b in rc[key]]
            if rounds is not None:
                pipeline = compute_pipeline(program, rounds)

        if self.metrics is not None:
            self.metrics.counter("machine_programs").inc()
            if pipeline is not None:
                self.metrics.histogram("machine_pipeline_speedup") \
                    .observe(pipeline.speedup)

        preport = ProgramReport(
            program=program, stage_reports=reports,
            backend=self.backend.name, pipeline=pipeline,
        )
        _each(shared, "on_program_end", preport.outputs)
        return preport

    # ------------------------------------------------------------------ #
    def _run_stage(
        self,
        stage: "ProgramStage",
        produced: Dict[str, np.ndarray],
        *,
        seed: int,
        check_outputs: bool,
        validate: Optional[bool],
        rtol: float,
        caller_instruments: Optional[List[object]],
        bind_caller: bool = True,
    ) -> RunReport:
        """One program node: resolve operands (refs against ``produced``),
        prepare, execute, check, validate — the former ``run`` body.

        ``bind_caller``: whether a caller-passed tracer/counter may bind to
        this stage's report.  True only for one-node programs — in a
        multi-stage program the caller's instruments accumulate across
        stages, and binding them per stage would overcount every stage's
        traffic/cycles by the program prefix.
        """
        from repro_torch.legion.program import Ref
        from repro_torch.legion.runtime import _instance_view, synthesize_operands

        workload = stage.workload
        ztb = stage.ztb
        if workload is not None:
            plan = plan_stage(self.cfg, workload, stage=stage.name)
            if stage.x is None and stage.w is None:
                x, w = synthesize_operands(
                    workload, seed=seed, ztb_sparsity=stage.ztb_sparsity,
                    k_window=(plan.assignments[0].k_window
                              if plan.assignments else 0),
                )
                if ztb is None and stage.ztb_sparsity > 0.0:
                    ztb = True
            else:
                x, w = stage.x, stage.w
        else:
            plan = stage.plan
            x, w = stage.x, stage.w
        if isinstance(x, Ref):
            x = x.resolve(produced)
        if isinstance(w, Ref):
            w = w.resolve(produced)

        ctx = prepare_context(
            self.cfg, plan, x, w, mode=stage.mode, ztb=ztb,
            granularity=self.granularity, kernel_backend=self.kernel_backend,
            emulate_cores=self.emulate_cores, accumulators=self.accumulators,
            device=self.device,
        )
        instruments = caller_instruments
        # Per-run instruments (fresh pair, or the caller's) come first; the
        # report's trace/cycles bind to them, never to session-lifetime
        # instruments whose totals span earlier runs.
        if instruments is None:
            per_run: List[object] = [
                TrafficTracer(),
                CycleCounter(self.cfg,
                             mem_bw_bytes_per_cycle=self.mem_bw),
            ]
        else:
            per_run = list(instruments)
        emit = per_run + self.instruments

        _each(emit, "on_plan_begin", plan, ctx.mode, ctx)
        outputs = self.backend.execute(ctx, emit)
        _each(emit, "on_plan_end", outputs)

        tracer = counter = None
        if caller_instruments is None or bind_caller:
            tracer = next(
                (i for i in per_run if isinstance(i, TrafficTracer)), None)
            counter = next(
                (i for i in per_run if isinstance(i, CycleCounter)), None)

        # Caller-supplied books may gate windows whose data is NOT zero —
        # outputs then intentionally diverge from the dense reference, so
        # only self-derived sparsity (ztb=True builds books from w's actual
        # zeros) keeps the check meaningful.
        caller_books = ztb not in (None, False, True)
        if check_outputs and not caller_books:
            x_arr, w_arr = np.asarray(x), np.asarray(w)
            for inst in range(ctx.count):
                if ctx.int_path:
                    xi = _instance_view(x_arr, inst, 2).astype(np.int64)
                    wi = _instance_view(w_arr, inst, 2).astype(np.int64)
                    got = outputs[inst].astype(np.int64)
                    mismatch = got != xi @ wi
                else:
                    xi = _instance_view(x_arr, inst, 2).astype(np.float64)
                    wi = _instance_view(w_arr, inst, 2).astype(np.float64)
                    got = outputs[inst]
                    mismatch = ~np.isclose(got, xi @ wi, rtol=1e-5,
                                           atol=1e-5)
                if mismatch.any():
                    raise AssertionError(
                        f"{plan.stage} instance {inst}: runtime output != "
                        f"x @ w reference at {int(mismatch.sum())} positions "
                        f"(mode {ctx.mode.name}, backend {self.backend.name})"
                    )

        report = RunReport(
            outputs=outputs, plan=plan, mode=ctx.mode,
            backend=self.backend.name, trace=tracer, cycles=counter,
            ztb_stats=ctx.ztb_stats(), workload=workload,
        )
        if self.metrics is not None:
            m = self.metrics
            m.counter("machine_stage_runs", labels=("stage",)) \
                .inc(stage=plan.stage)
            if counter is not None:
                m.counter("machine_cycles").inc(counter.total_cycles)
                m.counter("machine_passes").inc(counter.executed_passes)
                m.counter("machine_skipped_passes") \
                    .inc(counter.skipped_passes)
            if tracer is not None:
                totals = tracer.totals
                m.counter("machine_weight_bytes").inc(totals.weight_bytes)
                m.counter("machine_act_bytes").inc(totals.act_bytes)
                m.counter("machine_psum_bytes").inc(totals.psum_bytes)
        # Per-stage validation against the analytic simulator.  Auto mode
        # (validate=None) requires the measuring instruments to be this
        # run's own fresh pair (caller-passed instruments may carry earlier
        # runs' totals) and simulate() to model the run (its ZTB discount
        # applies to sub-8-bit weight stages only).  An explicit
        # validate=True refuses to degrade silently.
        if validate and workload is None:
            raise ValueError(
                "validate=True needs a GEMMWorkload run — an explicit plan "
                "has no analytic simulate() counterpart"
            )
        if validate is not False and workload is not None:
            models_run = report.ztb_stats is None or workload.weight_bits < 8
            measurable = tracer is not None and counter is not None
            if validate:
                if not measurable:
                    raise ValueError(
                        "validate=True needs a TrafficTracer and a "
                        "CycleCounter among the per-run instruments"
                    )
                if not models_run:
                    raise ValueError(
                        "validate=True: simulate() models ZTB only for "
                        "sub-8-bit weights — this run has no analytic "
                        "counterpart"
                    )
            if measurable and models_run and \
                    (validate or instruments is None):
                sim = simulate_workload(
                    self.cfg, workload, ztb=report.ztb_stats,
                    mem_bw_bytes_per_cycle=self.mem_bw)
                scale = workload.layers
                br = counter.stage_breakdown().get(
                    plan.stage, CycleBreakdown()).scaled(scale)
                report.traffic_validation, report.cycle_validation = \
                    _build_validations(plan.stage,
                                       tracer.totals.scaled(scale), br, sim,
                                       rtol)
        return report

    # ------------------------------------------------------------------ #
    def cross_validate(
        self,
        workloads: Sequence[GEMMWorkload],
        *,
        rtol: float = 0.05,
        seed: int = 0,
        ztb_sparsity: float = 0.0,
        check_outputs: bool = True,
    ) -> Tuple[List[StageValidation], List[CycleValidation]]:
        """Execute every workload through this machine and compare measured
        per-stage traffic AND cycles against ``simulate()`` in one pass.

        One layer of each workload executes numerically; measured totals
        scale by ``w.layers`` — the convention the old module-level
        ``cross_validate``/``cross_validate_cycles`` (now thin wrappers over
        this) always used.  Quantized stages get ``ztb_sparsity`` pruning;
        8-bit act-to-act stages stay dense.
        """
        workloads = list(workloads)
        ztb_stats: Optional[ZTBStats] = None
        per_traffic: Dict[str, TrafficTotals] = {}
        per_cycles: Dict[str, CycleBreakdown] = {}
        for w in workloads:
            rep = self.run(
                w, seed=seed,
                ztb_sparsity=ztb_sparsity if w.weight_bits < 8 else 0.0,
                check_outputs=check_outputs, validate=False,
            )
            if rep.ztb_stats is not None and ztb_stats is None:
                ztb_stats = rep.ztb_stats
            per_traffic.setdefault(w.stage, TrafficTotals()).add(
                rep.trace.totals.scaled(w.layers))
            for stage, br in rep.cycles.stage_breakdown().items():
                per_cycles.setdefault(stage, CycleBreakdown()).add(
                    br.scaled(w.layers))

        report = simulate(self.cfg, workloads, ztb=ztb_stats,
                          mem_bw_bytes_per_cycle=self.mem_bw)
        traffic_vals: List[StageValidation] = []
        cycle_vals: List[CycleValidation] = []
        for stage, measured in per_traffic.items():
            tv, cv = _build_validations(
                stage, measured, per_cycles.get(stage, CycleBreakdown()),
                report.stages[stage], rtol,
            )
            traffic_vals.append(tv)
            cycle_vals.append(cv)
        return traffic_vals, cycle_vals
