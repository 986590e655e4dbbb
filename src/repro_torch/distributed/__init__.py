"""Distribution substrate: sharding rules, collectives, pipeline stages
(the port of ``repro.distributed``), and the process group they run in.

:func:`init_process_group` starts a ``torch.distributed`` group from a
``file://`` store, with a timeout on every collective: NCCL on the card,
``gloo`` only when the caller asks for the CPU (``device="cpu"``), as the
tests' multi-process worlds do.  Nothing falls back: asked for NCCL
without a card, it raises.  On one H100 the card's groups have one rank
(NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.pipeline import bubble_fraction, gpipe
from repro_torch.distributed.sharding import (
    Rules,
    active_rules,
    constrain,
    make_rules,
    param_shardings,
    use_rules,
)

__all__ = ["Rules", "active_rules", "bubble_fraction", "constrain",
           "gpipe", "init_process_group", "make_rules", "param_shardings",
           "process_group", "use_rules"]

DEFAULT_TIMEOUT_S = 120.0


def init_process_group(init_file: str, rank: int, world_size: int, *,
                       device: DeviceLike = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join rank ``rank`` of ``world_size`` to the default process group
    through the store file ``init_file`` (absolute path; every rank passes
    the same one, and it must not hold a finished group's store).

    ``device=None`` is the card: NCCL, rank ``r`` on CUDA device
    ``r % device_count``; raises without one.  ``device="cpu"`` is
    ``gloo``.  Every collective of the group raises after ``timeout_s``
    seconds instead of waiting on a rank that never comes.  Returns the
    rank's device."""
    import torch.distributed as dist

    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for an NCCL "
                               "process group; pass device='cpu' for gloo")
        dev = (torch.device("cuda", rank % torch.cuda.device_count())
               if device is None or torch.device(device).index is None
               else torch.device(device))
        backend = "nccl"
    elif torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: a group runs on the card "
                         "(nccl) or the CPU (gloo)")
    if not os.path.isabs(init_file):
        raise ValueError(f"init_file must be an absolute path: {init_file}")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@contextlib.contextmanager
def process_group(init_file: str, rank: int, world_size: int, **kw):
    """:func:`init_process_group` for the body of a ``with``; the group is
    destroyed on the way out, also when the body raises."""
    import torch.distributed as dist

    dev = init_process_group(init_file, rank, world_size, **kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
