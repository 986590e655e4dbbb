"""Device resolution shared by every entry point of the port.

Entry points run on the CUDA card unless the caller asks for the CPU by
passing ``device="cpu"`` (as the tests do).  Nothing falls back: with no
card and no explicit device, :func:`resolve_device` raises.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)``, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_CARD_TRACE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "card_trace", default=False)


@contextlib.contextmanager
def card_trace():
    """Trace the card's program on fake tensors of any device: inside, a
    kernel wrapper given a ``FakeTensor`` takes its kernel's route (the
    custom op, whose fake implementation runs) as it would for a CUDA
    tensor.  The dry run (``repro_torch.launch.dryrun``) traces on fake
    CPU tensors, which need no card and no CUDA build of torch; real
    tensors are not affected."""
    token = _CARD_TRACE.set(True)
    try:
        yield
    finally:
        _CARD_TRACE.reset(token)


def card_tracing() -> bool:
    """Whether :func:`card_trace` is active."""
    return _CARD_TRACE.get()


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route: a CUDA tensor, or a fake
    tensor inside :func:`card_trace`."""
    if t.is_cuda:
        return True
    if not _CARD_TRACE.get():
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)
