"""The one traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and makes its inputs from the seed on the device.

A training mix gives the batch rows and sequence length of a step; each
step takes a new batch of token ids drawn uniformly over the vocabulary,
its targets the next ids.  Every seed gives the same sizes; only the ids
differ."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

TOKEN_STREAM = 2 ** 40      # apart from the weights' generator seeds


def load(root: Path, mix: str) -> Dict:
    return json.loads((root / "portbench" / "traffic" / f"{mix}.json")
                      .read_text())


class TokenBatches:
    """Batches {"tokens", "targets"} of int32 ids [batch, seq], one a call,
    drawn in order from one generator seeded from ``seed``."""

    def __init__(self, traffic: Dict, vocab: int, seed: int, device):
        self.shape = (traffic["batch"], traffic["seq"] + 1)
        self.vocab = vocab
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed((int(seed) * 4099 + TOKEN_STREAM) % 2 ** 63)

    def next(self) -> Dict[str, torch.Tensor]:
        ids = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                            device=self.device, dtype=torch.int32)
        return {"tokens": ids[:, :-1], "targets": ids[:, 1:]}
