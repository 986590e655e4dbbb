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
The kernel has no backward yet: a CUDA call whose float inputs need a
gradient raises (``refuse_grad``), so Mamba-2 and Zamba2 train only on
the CPU until it has one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import card_tracing, on_card
from repro_torch.kernels import cost
from repro_torch.kernels.bitlinear.ops import refuse_grad
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_scan_ref

BACKENDS = ("auto", "reference", "naive", "cuda")
LAUNCHES: Dict[str, int] = {"float32": 0}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


# scans a traced run took by route (:func:`route`)
ROUTES: Dict[str, int] = {"kernel": 0, "grouped": 0}


def reset_launches() -> None:
    LAUNCHES["float32"] = 0


def route(dtx: torch.Tensor) -> str:
    """Which scan the model runs on ``dtx`` (a tensor or a DTensor):
    ``"grouped"`` (``ref.ssd_grouped_scan``, differentiable) where a
    traced run of the card's program (``device.card_trace``) needs the
    gradient, which the kernel does not give; else ``"kernel"``, the
    :func:`ssd` wrapper (the kernel on the card, which refuses a gradient;
    its plain version on the CPU).  Counted in ``ROUTES``."""
    grouped = (card_tracing() and torch.is_grad_enabled()
               and dtx.requires_grad)
    which = "grouped" if grouped else "kernel"
    ROUTES[which] += 1
    return which


def _resolve(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if on_card(t) else "reference"
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


# op overload packet -> bytes the launch moves, from its arguments
BYTES = {torch.ops.repro_torch.ssd_scan: _ssd_bytes,
         torch.ops.repro_torch.ssd_scan_state: _ssd_bytes}


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
    split, ``[B, H, S, ...]`` -> ``y [B, H, S, P]``, so that a head-shared
    B/C can be an ``expand`` view with head stride 0 (the kernel reads it
    uncopied).  ``S`` need not be a multiple of ``chunk``.
    ``return_state=True`` also returns the terminal state ``[BH, N, P]``
    (``[B, H, N, P]``): the prefill-to-decode handoff, which the kernel
    writes from the state it already holds.
    """
    split = dtx.ndim == 4
    lead = tuple(dtx.shape[:2]) if split else (dtx.shape[0],)
    s, p = dtx.shape[-2:]
    n = b.shape[-1]
    want = {"dta": lead + (s,), "b": lead + (s, n), "c": lead + (s, n)}
    for label, t in (("dta", dta), ("b", b), ("c", c)):
        if tuple(t.shape) != want[label]:
            raise ValueError(f"{label} {tuple(t.shape)} != {want[label]} "
                             f"(dtx {tuple(dtx.shape)})")
    if _resolve(backend, dtx) == "cuda":
        refuse_grad("ssd", "ROADMAP.md Queue 1, item 4: the SSD backward",
                    dta, dtx, b, c)
        if not split:
            dta, dtx, b, c = (t.unsqueeze(0) for t in (dta, dtx, b, c))
        scratch = _scratch(dtx, n, chunk)
        if return_state:
            y, h = torch.ops.repro_torch.ssd_scan_state(dta, dtx, b, c,
                                                         scratch, chunk)
        else:
            y, h = torch.ops.repro_torch.ssd_scan(dta, dtx, b, c, scratch,
                                                  chunk), None
        if not split:
            y, h = y[0], (h[0] if h is not None else None)
        return (y, h) if return_state else y
    bh = lead[0] * lead[1] if split else lead[0]
    out = _plain(dta.reshape(bh, s), dtx.reshape(bh, s, p),
                 b.reshape(bh, s, n), c.reshape(bh, s, n), chunk,
                 backend == "naive", return_state)
    if not split:
        return out
    if return_state:
        return out[0].reshape(*lead, s, p), out[1].reshape(*lead, n, p)
    return out.reshape(*lead, s, p)
