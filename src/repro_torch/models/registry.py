"""Model registry: one functional API for every architecture family.

The transformer module serves the ``dense``, ``moe``, ``encoder`` and
``vlm`` families, ``mamba2`` the Mamba-2 SSM family (``ssm``) and
``hybrid`` the Zamba2-style hybrid.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid, mamba2, transformer
from repro_torch.models.common import cross_entropy


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Functional model bundle for one config on one device."""

    cfg: Any
    device: torch.device
    init: Callable                 # (seed | torch.Generator) -> params
    train_logits: Callable         # (params, batch) -> logits
    loss: Callable                 # (params, batch) -> scalar, differentiable
    init_cache: Callable           # (batch, max_seq) -> cache
    prefill: Callable              # (params, batch, cache) -> (logits, cache)
    # (params, token, cache, pos) -> (logits, cache); None for an encoder
    decode: Optional[Callable]
    # (params, tokens [B,C], cache, pos0) -> (logits, cache); chunked
    # in-flight prefill — only decoder transformers without a frontend
    # support it.
    prefill_chunk: Optional[Callable] = None


def _generator(seed: Union[int, torch.Generator],
               device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


# family -> module with init_params / forward_train / init_cache /
# forward_prefill / forward_decode (the JAX package's _transformer_api,
# _mamba_api and _hybrid_api, which differ only in the module)
_MODULES = {"dense": transformer, "moe": transformer, "encoder": transformer,
            "vlm": transformer, "ssm": mamba2, "hybrid": hybrid}


def build_model(cfg, *, device: DeviceLike = None) -> ModelAPI:
    """The model API of ``cfg`` on ``device`` (default: the CUDA card)."""
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family {cfg.family}")
    device = resolve_device(device)
    m = _MODULES[cfg.family]

    def loss(params, batch):
        logits = m.forward_train(cfg, params, batch)
        if cfg.frontend == "vision_patches":
            # patch positions carry no next-token target
            logits = logits[:, cfg.num_patches:, :]
        return cross_entropy(logits, batch["targets"])

    decode = prefill_chunk = None
    if cfg.is_decoder:
        decode = (lambda params, token, cache, pos:
                  m.forward_decode(cfg, params, token, cache, pos))
        if m is transformer and cfg.frontend not in ("audio_frames",
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
        loss=loss,
        init_cache=lambda batch, max_seq: m.init_cache(cfg, batch, max_seq,
                                                       device),
        prefill=lambda params, batch, cache: m.forward_prefill(
            cfg, params, batch, cache),
        decode=decode,
        prefill_chunk=prefill_chunk,
    )


def make_batch_spec(cfg, shape, *, device: DeviceLike = "meta"
                    ) -> Dict[str, torch.Tensor]:
    """Storage-free stand-ins for every model input of a shape cell: empty
    tensors on ``device`` (the meta device, or any device under the
    caller's ``FakeTensorMode``), with the names, shapes and types of the
    JAX package's ``ShapeDtypeStruct`` s.

    For train: the full (tokens, targets) pair; an encoder gets frames,
    a VLM (tokens, patch_embeds, targets)."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        # zeros: on the meta device or under a fake mode they hold nothing,
        # and a real run of a cell reads valid token ids
        return torch.zeros(shp, dtype=dtype, device=device)

    i32 = torch.int32
    if cfg.frontend == "audio_frames":
        return {"frames": sds((b, s, cfg.d_model), getattr(torch, cfg.dtype)),
                "targets": sds((b, s), i32)}
    if cfg.frontend == "vision_patches":
        text = s - cfg.num_patches
        return {"tokens": sds((b, text), i32),
                "patch_embeds": sds((b, cfg.num_patches, cfg.d_model),
                                    getattr(torch, cfg.dtype)),
                "targets": sds((b, text), i32)}
    return {"tokens": sds((b, s), i32), "targets": sds((b, s), i32)}
