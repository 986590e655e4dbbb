"""Model registry: one functional API per architecture family.

The port covers the dense decoder transformer, the Mamba-2 SSM family
(``ssm``) and the Zamba2-style ``hybrid``; ``moe``, ``encoder`` and ``vlm``
raise until their slices (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, mamba2, transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Functional model bundle for one config on one device."""

    cfg: Any
    device: torch.device
    init: Callable                 # (seed | torch.Generator) -> params
    train_logits: Callable         # (params, batch) -> logits
    init_cache: Callable           # (batch, max_seq) -> cache
    prefill: Callable              # (params, batch, cache) -> (logits, cache)
    decode: Optional[Callable]     # (params, token, cache, pos) -> (logits, cache)
    # (params, tokens [B,C], cache, pos0) -> (logits, cache); chunked
    # in-flight prefill — only decoder transformers support it.
    prefill_chunk: Optional[Callable] = None


def _generator(seed: Union[int, torch.Generator],
               device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# family -> module with init_params / forward_train / init_cache /
# forward_prefill / forward_decode (the JAX package's _dense_api,
# _mamba_api and _hybrid_api, which differ only in the module)
_MODULES = {"dense": transformer, "ssm": mamba2, "hybrid": hybrid}


def build_model(cfg, *, device: DeviceLike = None) -> ModelAPI:
    """The model API of ``cfg`` on ``device`` (default: the CUDA card)."""
    if cfg.family not in _MODULES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            "port serves the dense, ssm and hybrid families (ROADMAP.md, "
            "Queue 1)"
        )
    device = resolve_device(device)
    m = _MODULES[cfg.family]
    prefill_chunk = None
    if cfg.family == "dense" and cfg.frontend not in ("audio_frames",
                                                      "vision_patches"):
        prefill_chunk = (lambda params, tokens, cache, pos0:
                         transformer.forward_prefill_chunk(
                             cfg, params, tokens, cache, pos0))
    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda seed: m.init_params(cfg, _generator(seed, device),
                                        device),
        train_logits=lambda params, batch: m.forward_train(cfg, params,
                                                           batch),
        init_cache=lambda batch, max_seq: m.init_cache(cfg, batch, max_seq,
                                                       device),
        prefill=lambda params, batch, cache: m.forward_prefill(
            cfg, params, batch, cache),
        decode=lambda params, token, cache, pos: m.forward_decode(
            cfg, params, token, cache, pos),
        prefill_chunk=prefill_chunk,
    )
