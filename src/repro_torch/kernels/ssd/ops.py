"""Public wrapper of the SSD scan CUDA kernel with backend selection.

``backend="auto"`` launches the kernel (``csrc/ssd.cu``) for CUDA tensors
and runs the chunked plain version (``ref.py``) for CPU tensors;
``"naive"`` runs the per-step recurrence and ``"reference"`` the chunked
plain version, both on CPU tensors only; ``"cuda"`` forces the kernel.
Nothing falls back: a CUDA tensor goes through the kernel or raises.
``LAUNCHES`` counts calls that launched the kernel (one per call, although
a call issues three CUDA kernels: chunk states, the pass over the
chunks, the scan), so a run can show that its path went through it.
Each call is a ``torch.library`` custom op (``repro_torch::ssd_scan``,
``ssd_scan_state``) with a fake implementation, a FLOP formula and a byte
formula (``BYTES``), so that a traced run on fake tensors (the dry run)
passes through it; the scratch the kernel needs is allocated before the op
and handed to it, so that a memory tracker sees it.

Under autograd (grad enabled and an input requiring a gradient) the
``"cuda"`` and ``"reference"`` routes go through :class:`SSDScan`: its
forward is the same launch (or plain version), and it saves the inputs and
the kernel's scratch, which holds each chunk's entering state after the
call; its backward is the backward kernel (``csrc/ssd_bwd.cu``, custom op
``repro_torch::ssd_scan_bwd``, counted in ``LAUNCHES["backward_float32"]``)
on the card and ``ssd_chunked_bwd_ref`` on the CPU.  B and C may also come
as ``[B, S, N]`` shared by the heads (Mamba-2's single group): the
backward kernel then takes the heads in groups (:func:`head_group`), sums
their gradients over each group's heads inside a block and the groups'
partials after it, in a fixed order.

A traced run of the card's program (``device.card_trace``: the dry run)
takes the custom ops for every tensor, fake or real: on real CPU tensors
they run their plain versions (their CPU kernels below, which count no
launch), so a real run of a traced cell allocates what its fake trace
counts (the scratch, the backward's work, the outputs).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import card_tracing, on_card
from repro_torch.kernels import cost
from repro_torch.kernels.ssd.ref import (
    ssd_chunked_bwd_ref, ssd_chunked_ref, ssd_scan_ref,
)

BACKENDS = ("auto", "reference", "naive", "cuda")
# forward launches (three CUDA kernels each) and backward calls (four, or
# three where the heads do not share B and C)
LAUNCHES: Dict[str, int] = {"float32": 0, "backward_float32": 0}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


# the H100's streaming multiprocessors (where no card is present to say),
# and a head group's fixed cost in heads' work (C B^T, the group's dB and
# dC products and its staging), fitted to the scan kernel's times at
# G = 2 .. 28 on the three rows of chip_smoke.SSD_BWD_SHAPES
# (tools/ssd_bwd_ab.py --groups; 1.45 fits best, 0.5 leaves 7x the
# squared log error), which :func:`head_group` weighs
SMS, GROUP_COST = 132, 1.5

def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _resolve(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "auto":
        # a traced run takes the custom ops on real CPU tensors too
        return "cuda" if on_card(t) or card_tracing() else "reference"
    if backend == "cuda" and not on_card(t):
        raise ValueError(f"backend='cuda' needs CUDA tensors; got {t.device}")
    if backend != "cuda" and t.is_cuda:
        raise ValueError(
            f"backend={backend!r} runs a plain version on CPU tensors only; "
            "CUDA tensors go through the kernel")
    return backend


def scratch_sizes(nb: int, nh: int, s: int, n: int, p: int,
                  chunk: int) -> tuple:
    """Float32 elements of the kernel's two scratch arrays, which the
    wrapper allocates as one: each chunk's state ``[B, H, nc, N, P]``
    (overwritten with the state entering the chunk) and its total log decay
    ``[B, H, nc]``."""
    nc = -(-s // chunk)
    return nb * nh * nc * n * p, nb * nh * nc


def _scratch(dtx, n: int, chunk: int) -> torch.Tensor:
    nb, nh, s, p = dtx.shape
    return torch.empty(sum(scratch_sizes(nb, nh, s, n, p, chunk)),
                       dtype=torch.float32, device=dtx.device)


def _outputs(dtx, n: int, return_state: bool):
    """y in [batch, S, heads, P] memory order (the model reads it that
    way) and the terminal state, as the kernel writes them."""
    nb, nh, s, p = dtx.shape
    y = torch.empty((nb, s, nh, p), dtype=torch.float32,
                    device=dtx.device).transpose(1, 2)
    h = (torch.empty((nb, nh, n, p), dtype=torch.float32, device=dtx.device)
         if return_state else None)
    return y, h


def _launch(dta, dtx, b, c, chunk: int, return_state: bool,
            scratch: Optional[torch.Tensor] = None):
    """The kernel over 4-D [batch, heads, S, ...] views; returns
    (y [batch, heads, S, P], h_final [batch, heads, N, P] or None).
    ``scratch`` holds :func:`scratch_sizes` float32 elements (allocated
    here if None)."""
    from repro_torch.kernels.build import library

    tensors = (("dta", dta), ("dtx", dtx), ("b", b), ("c", c))
    if any(t.dtype != torch.float32 for _, t in tensors):
        raise TypeError("the SSD kernel takes float32 dta, dtx, b and c; got "
                        + ", ".join(str(t.dtype) for _, t in tensors))
    if any(t.device != dtx.device for _, t in tensors):
        raise ValueError("dta, dtx, b and c must lie on one CUDA device")
    for label, t in tensors[1:]:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{label} needs unit stride along its last axis")
    nb, nh, s, p = dtx.shape
    n = b.shape[-1]
    if not 1 <= chunk <= MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got "
                         f"chunk={chunk}, P={p}, N={n}")
    y, h = _outputs(dtx, n, return_state)
    if s == 0:
        return y, (h.zero_() if h is not None else None)
    n_states, _ = scratch_sizes(nb, nh, s, n, p, chunk)
    if scratch is None:
        scratch = _scratch(dtx, n, chunk)
    states = scratch.data_ptr()
    decay = states + 4 * n_states
    fn = library("ssd").ssd_launch
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, ll, ll, ll] * 5 + [vp] * 3 + [ci] * 6 + [vp]
        fn.restype = ci
    args = []
    for t in (dta, dtx, b, c, y):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    rc = fn(*args, h.data_ptr() if h is not None else None, states, decay,
            nb, nh, s, p, n, chunk,
            torch.cuda.current_stream(dtx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc} "
                           f"(B={nb} H={nh} S={s} P={p} N={n} "
                           f"chunk={chunk})")
    LAUNCHES["float32"] += 1
    return y, h


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=("scratch",),
                         device_types="cuda")
def _ssd_op(dta: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, scratch: torch.Tensor,
            chunk: int) -> torch.Tensor:
    return _launch(dta, dtx, b, c, chunk, False, scratch)[0]


@_ssd_op.register_fake
def _(dta, dtx, b, c, scratch, chunk):
    return _outputs(dtx, b.shape[-1], False)[0]


@torch.library.custom_op("repro_torch::ssd_scan_state",
                         mutates_args=("scratch",), device_types="cuda")
def _ssd_state_op(dta: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, scratch: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(dta, dtx, b, c, chunk, True, scratch)


@_ssd_state_op.register_fake
def _(dta, dtx, b, c, scratch, chunk):
    return _outputs(dtx, b.shape[-1], True)


@register_flop_formula([torch.ops.repro_torch.ssd_scan,
                        torch.ops.repro_torch.ssd_scan_state], get_raw=True)
def _ssd_flops(dta, dtx, b, c, scratch, chunk, *a, **kw):
    nb, nh, s, p = dtx.shape
    return int(cost.ssd_flops(nb, nh, s, b.shape[-1], p, chunk))


def _ssd_bytes(dta, dtx, b, c, scratch, chunk):
    nb, nh, s, p = dtx.shape
    shared = b.stride(1) == 0 and c.stride(1) == 0
    return cost.ssd_bytes(nb, nh, s, b.shape[-1], p, shared)


def head_group(nb: int, nh: int, nc: int) -> int:
    """Heads a block of the backward's scan takes where they share B and C:
    the G that minimises (waves of ceil(H / G) x chunks x batch blocks,
    one block an SM of the card's, or of an H100's where no card is
    present) x (G + GROUP_COST), the larger G on a tie (fewer partials to
    sum).  A block computes C B^T once for its group and its dB and dC
    products once, so a larger G saves work until the grid no longer
    fills the card: 28 at Zamba2-7B's training shape (112 heads, 32
    chunks: 128 blocks, one wave), 6 at Mamba2-130m's (24 heads: 128
    blocks), 7 at a 1000-token Zamba2 prompt (8 chunks: 128 blocks), each
    the fastest G measured there."""
    sms = (torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
        if torch.cuda.is_available() else SMS)

    def cost(g):
        blocks = -(-nh // g) * nc * nb
        return -(-blocks // sms) * (g + GROUP_COST)

    return min(range(1, nh + 1), key=lambda g: (cost(g), -g))


def bwd_work_sizes(nb: int, nh: int, s: int, n: int, p: int, chunk: int,
                   shared: bool) -> tuple:
    """Float32 elements of the backward's scratch, which the wrapper
    allocates as one: the state gradients ``[B, H, nc, N, P]`` and, where
    the heads share B and C, each head group's dB and dC
    ``[B, ceil(H / G), S, N]`` (:func:`head_group`) before their sum over
    the groups."""
    nc = -(-s // chunk)
    groups = -(-nh // head_group(nb, nh, nc)) if shared else 0
    return nb * nh * nc * n * p, 2 * nb * groups * s * n


def _bwd_work(dtx, b, chunk: int) -> torch.Tensor:
    nb, nh, s, p = dtx.shape
    return torch.empty(sum(bwd_work_sizes(nb, nh, s, b.shape[-1], p, chunk,
                                          b.ndim == 3)),
                       dtype=torch.float32, device=dtx.device)


def _bwd_outputs(dtx, b):
    """ddta and ddtx in [batch, S, heads, ...] memory order (as the model
    holds dta and dtx), db and dc in b's shape."""
    nb, nh, s, p = dtx.shape
    f32, dev = torch.float32, dtx.device
    ddta = torch.empty((nb, s, nh), dtype=f32, device=dev).transpose(1, 2)
    ddtx = torch.empty((nb, s, nh, p), dtype=f32, device=dev).transpose(1, 2)
    db, dc = (torch.empty(b.shape, dtype=f32, device=dev) for _ in range(2))
    return ddta, ddtx, db, dc


def _per_head(b, c, nh: int):
    """B and C as [batch, heads, S, N]: a ``[batch, S, N]`` pair shared by
    the heads becomes a head-stride-0 view, uncopied."""
    if b.ndim == 4:
        return b, c
    nb, s, n = b.shape
    return tuple(t[:, None].expand(nb, nh, s, n) for t in (b, c))


def _launch_bwd(dta, dtx, b, c, dy, scratch, h_final, dh_final, chunk: int,
                work: Optional[torch.Tensor] = None):
    """The backward kernels over 4-D [batch, heads, S, ...] views, with b
    and c ``[batch, heads, S, N]`` or ``[batch, S, N]`` shared by the
    heads; ``scratch`` is the forward launch's after its call, and
    ``h_final`` (its terminal state) is given exactly when ``dh_final`` is.
    Returns (ddta, ddtx, db, dc), db and dc in b's shape; ``work`` holds
    :func:`bwd_work_sizes` float32 elements (allocated here if None)."""
    from repro_torch.kernels.build import library

    tensors = (("dta", dta), ("dtx", dtx), ("b", b), ("c", c), ("dy", dy))
    if any(t.dtype != torch.float32 for _, t in tensors):
        raise TypeError("the SSD backward takes float32 dta, dtx, b, c and "
                        "dy; got " + ", ".join(str(t.dtype) for _, t in
                                               tensors))
    if any(t.device != dtx.device for _, t in tensors):
        raise ValueError("dta, dtx, b, c and dy must lie on one CUDA device")
    for label, t in tensors[1:]:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{label} needs unit stride along its last axis")
    if (h_final is None) != (dh_final is None):
        raise ValueError("h_final and dh_final are given together")
    nb, nh, s, p = dtx.shape
    n = b.shape[-1]
    if not 1 <= chunk <= MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the SSD kernel takes chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}; got "
                         f"chunk={chunk}, P={p}, N={n}")
    shared = b.ndim == 3
    ddta, ddtx, db, dc = _bwd_outputs(dtx, b)
    if s == 0:
        return ddta.zero_(), ddtx.zero_(), db.zero_(), dc.zero_()
    n_grads, n_part = bwd_work_sizes(nb, nh, s, n, p, chunk, shared)
    group = head_group(nb, nh, -(-s // chunk)) if shared else 1
    if work is None:
        work = _bwd_work(dtx, b, chunk)
    if shared:
        part_b, part_c = work[n_grads:n_grads + n_part].view(
            2, nb, -(-nh // group), s, n).unbind(0)
        heads_b, heads_c, sums = part_b, part_c, (db, dc)
    else:
        heads_b, heads_c, sums = db, dc, (None, None)
    b4, c4 = _per_head(b, c, nh)
    states = scratch.data_ptr()
    decay = states + 4 * scratch_sizes(nb, nh, s, n, p, chunk)[0]
    fn = library("ssd_bwd").ssd_bwd_launch
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, ll, ll, ll] * 9 + [vp] * 7 + [ci] * 7 + [vp]
        fn.restype = ci
    args = []
    for t in (dta, dtx, b4, c4, dy, ddta, ddtx, heads_b, heads_c):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = fn(*args, states, decay, ptr(h_final), ptr(dh_final),
            work.data_ptr(), ptr(sums[0]), ptr(sums[1]), nb, nh, s, p, n,
            chunk, group, torch.cuda.current_stream(dtx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd backward kernel launch failed: CUDA error "
                           f"{rc} (B={nb} H={nh} S={s} P={p} N={n} "
                           f"chunk={chunk} shared={shared} group={group})")
    LAUNCHES["backward_float32"] += 1
    return ddta, ddtx, db, dc


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=("work",),
                         device_types="cuda")
def _ssd_bwd_op(dta: torch.Tensor, dtx: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, dy: torch.Tensor, scratch: torch.Tensor,
                h_final: Optional[torch.Tensor],
                dh_final: Optional[torch.Tensor], work: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    return _launch_bwd(dta, dtx, b, c, dy, scratch, h_final, dh_final,
                       chunk, work)


@_ssd_bwd_op.register_fake
def _(dta, dtx, b, c, dy, scratch, h_final, dh_final, work, chunk):
    return _bwd_outputs(dtx, b)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd, get_raw=True)
def _ssd_bwd_flops(dta, dtx, b, c, dy, scratch, h_final, dh_final, work,
                   chunk, *a, **kw):
    nb, nh, s, p = dtx.shape
    group = head_group(nb, nh, -(-s // chunk)) if b.ndim == 3 else 1
    return int(cost.ssd_bwd_flops(nb, nh, s, b.shape[-1], p, chunk, group))


def _ssd_bwd_bytes(dta, dtx, b, c, dy, scratch, h_final, dh_final, work,
                   chunk):
    nb, nh, s, p = dtx.shape
    shared = b.ndim == 3 or (b.stride(1) == 0 and c.stride(1) == 0)
    return cost.ssd_bwd_bytes(nb, nh, s, b.shape[-1], p, shared,
                              dh_final is not None)


# op overload packet -> bytes the launch moves, from its arguments
BYTES = {torch.ops.repro_torch.ssd_scan: _ssd_bytes,
         torch.ops.repro_torch.ssd_scan_state: _ssd_bytes,
         torch.ops.repro_torch.ssd_scan_bwd: _ssd_bwd_bytes}


def _plain(dta, dtx, b, c, chunk: int, naive: bool, return_state: bool):
    """The plain versions over [BH, ...] tensors; S is padded to a chunk
    multiple with dta = 0 and zero inputs, which leaves the outputs and the
    terminal state unchanged (as the JAX model pads)."""
    s = dtx.shape[1]
    if naive:
        return ssd_scan_ref(dta, dtx, b, c, return_state=return_state)
    pad = (-s) % chunk
    if pad:
        dta = F.pad(dta, (0, pad))
        dtx, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dtx, b, c))
    out = ssd_chunked_ref(dta, dtx, b, c, chunk=chunk,
                          return_state=return_state)
    if not pad:
        return out
    return (out[0][:, :s], out[1]) if return_state else out[:, :s]


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, *t.shape[2:])


def _plain4(dta, dtx, b, c, chunk: int, naive: bool, return_state: bool):
    """:func:`_plain` over [batch, heads, S, ...] tensors, b and c per head
    or shared; returns (y [B, H, S, P], h [B, H, N, P] or None)."""
    nb, nh, s, p = dtx.shape
    b, c = _per_head(b, c, nh)
    out = _plain(_flat(dta), _flat(dtx), _flat(b), _flat(c), chunk, naive,
                 return_state)
    y, h = out if return_state else (out, None)
    return (y.reshape(nb, nh, s, p),
            h.reshape(nb, nh, *h.shape[1:]) if h is not None else None)


def _forward(dta, dtx, b, c, chunk: int, backend: str, return_state: bool):
    """(y, terminal state or None, the kernel's scratch or None) over
    [batch, heads, S, ...] tensors, b and c per head or shared: the
    kernel's custom op on the ``"cuda"`` route (its scratch then holds the
    state entering each chunk), else the plain version."""
    if backend != "cuda":
        return (*_plain4(dta, dtx, b, c, chunk, backend == "naive",
                         return_state), None)
    b4, c4 = _per_head(b, c, dtx.shape[1])
    scratch = _scratch(dtx, b.shape[-1], chunk)
    if return_state:
        y, h = torch.ops.repro_torch.ssd_scan_state(dta, dtx, b4, c4,
                                                     scratch, chunk)
    else:
        y, h = torch.ops.repro_torch.ssd_scan(dta, dtx, b4, c4, scratch,
                                              chunk), None
    return y, h, scratch


def _plain_bwd(dta, dtx, b, c, dy, chunk: int, dh_final):
    """``ssd_chunked_bwd_ref`` over [batch, heads, S, ...] tensors; where
    the heads share b and c (``[batch, S, N]``) their gradients are summed
    over the heads."""
    nb, nh, s, p = dtx.shape
    b4, c4 = _per_head(b, c, nh)
    ddta, ddtx, db, dc = ssd_chunked_bwd_ref(
        _flat(dta), _flat(dtx), _flat(b4), _flat(c4), _flat(dy),
        chunk=chunk,
        dh_final=_flat(dh_final) if dh_final is not None else None)
    db, dc = (t.reshape(nb, nh, s, -1) for t in (db, dc))
    if b.ndim == 3:
        db, dc = db.sum(1), dc.sum(1)
    return ddta.reshape(nb, nh, s), ddtx.reshape(nb, nh, s, p), db, dc


# The custom ops' CPU kernels, which a traced run on real CPU tensors
# reaches (``card_trace``): the plain versions, written into outputs laid
# out as the kernels lay out theirs.  Their temporaries are the ops' own,
# as the kernels' registers and shared memory are.
@_ssd_op.register_kernel("cpu")
def _(dta, dtx, b, c, scratch, chunk):
    y, _ = _outputs(dtx, b.shape[-1], False)
    return y.copy_(_plain4(dta, dtx, b, c, chunk, False, False)[0])


@_ssd_state_op.register_kernel("cpu")
def _(dta, dtx, b, c, scratch, chunk):
    y, h = _outputs(dtx, b.shape[-1], True)
    y_plain, h_plain = _plain4(dta, dtx, b, c, chunk, False, True)
    return y.copy_(y_plain), h.copy_(h_plain)


@_ssd_bwd_op.register_kernel("cpu")
def _(dta, dtx, b, c, dy, scratch, h_final, dh_final, work, chunk):
    return tuple(out.copy_(g) for out, g in zip(
        _bwd_outputs(dtx, b), _plain_bwd(dta, dtx, b, c, dy, chunk,
                                         dh_final)))


class SSDScan(torch.autograd.Function):
    """The SSD scan with its backward.  The forward is the kernel's custom
    op (``backend="cuda"``) or the chunked plain version
    (``"reference"``) on [batch, heads, S, ...] tensors, b and c per head
    or ``[batch, S, N]`` shared by the heads; it saves the inputs and, on
    the card, the kernel's scratch, whose state slots then hold the state
    entering each chunk (the backward kernel reads them rather than
    running the forward's kernels again), and the terminal state when it
    is returned.  The backward is ``repro_torch::ssd_scan_bwd`` on the
    card and ``ssd_chunked_bwd_ref`` on the CPU; a terminal state's
    gradient enters as ``dh_final``."""

    @staticmethod
    def forward(ctx, dta, dtx, b, c, chunk: int, backend: str,
                return_state: bool):
        ctx.set_materialize_grads(False)
        y, h, scratch = _forward(dta, dtx, b, c, chunk, backend,
                                 return_state)
        ctx.save_for_backward(dta, dtx, b, c, scratch, h)
        ctx.chunk, ctx.backend = chunk, backend
        return (y, h) if return_state else y

    @staticmethod
    def backward(ctx, dy, dh=None):
        dta, dtx, b, c, scratch, h = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(dtx)
        if ctx.backend != "cuda":
            grads = _plain_bwd(dta, dtx, b, c, dy, ctx.chunk, dh)
            return (*grads, None, None, None)
        if dy.stride(-1) != 1:          # autograd's tensor, not the model's
            dy = dy.contiguous()
        if dh is not None:
            dh = dh.contiguous()
        grads = torch.ops.repro_torch.ssd_scan_bwd(
            dta, dtx, b, c, dy, scratch, h if dh is not None else None, dh,
            _bwd_work(dtx, b, ctx.chunk), ctx.chunk)
        return (*grads, None, None, None)


def ssd(
    dta: torch.Tensor,
    dtx: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    chunk: int = 128,
    backend: str = "auto",
    return_state: bool = False,
):
    """Mamba-2 SSD: y from pre-scaled inputs (see ``csrc/ssd.cu``).

    Shapes as in the JAX package: ``dta [BH, S]``, ``dtx [BH, S, P]``,
    ``b``/``c [BH, S, N]`` -> ``y [BH, S, P]``; or with the leading axis
    split, ``[B, H, S, ...]`` -> ``y [B, H, S, P]``, where a head-shared
    B/C can be an ``expand`` view with head stride 0 (the kernel reads it
    uncopied) or ``[B, S, N]`` (its gradient then comes summed over the
    heads).  ``S`` need not be a multiple of ``chunk``.
    ``return_state=True`` also returns the terminal state ``[BH, N, P]``
    (``[B, H, N, P]``): the prefill-to-decode handoff, which the kernel
    writes from the state it already holds.  Differentiable: under
    autograd the kernel and plain routes go through :class:`SSDScan`.
    """
    split = dtx.ndim == 4
    lead = tuple(dtx.shape[:2]) if split else (dtx.shape[0],)
    s, p = dtx.shape[-2:]
    n = b.shape[-1]
    shared = split and b.ndim == 3
    bc_lead = lead[:1] if shared else lead
    want = {"dta": lead + (s,), "b": bc_lead + (s, n),
            "c": bc_lead + (s, n)}
    for label, t in (("dta", dta), ("b", b), ("c", c)):
        if tuple(t.shape) != want[label]:
            raise ValueError(f"{label} {tuple(t.shape)} != {want[label]} "
                             f"(dtx {tuple(dtx.shape)})")
    backend = _resolve(backend, dtx)
    if not split:
        dta, dtx, b, c = (t.unsqueeze(0) for t in (dta, dtx, b, c))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dta, dtx, b, c))
    if grad and backend != "naive":
        out = SSDScan.apply(dta, dtx, b, c, chunk, backend, return_state)
        y, h = out if return_state else (out, None)
    else:
        y, h, _ = _forward(dta, dtx, b, c, chunk, backend, return_state)
    if not split:
        y, h = y[0], (h[0] if h is not None else None)
    return (y, h) if return_state else y
