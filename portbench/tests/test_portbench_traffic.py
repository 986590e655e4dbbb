"""Token generation from the seed."""
from __future__ import annotations

import torch

from conftest import ROOT
from portbench import gen


def _batches(seed, n=3, vocab=1000, seq=32):
    traffic = dict(gen.load(ROOT, "train-4k"), seq=seq)
    b = gen.TokenBatches(traffic, vocab, seed, "cpu")
    return [b.next() for _ in range(n)]


def test_the_same_seed_gives_the_same_batches():
    big = 2 ** 31 + 987654321
    for a, b in zip(_batches(big), _batches(big)):
        assert torch.equal(a["tokens"], b["tokens"])
        assert torch.equal(a["targets"], b["targets"])


def test_seeds_and_steps_give_other_ids_of_the_same_sizes():
    a, b = _batches(5), _batches(6)
    assert not torch.equal(a[0]["tokens"], b[0]["tokens"])
    assert not torch.equal(a[0]["tokens"], a[1]["tokens"])
    for batch in a + b:
        assert batch["tokens"].shape == (1, 32)
        assert batch["tokens"].dtype == torch.int32
        assert 0 <= int(batch["tokens"].min()) and \
            int(batch["tokens"].max()) < 1000


def test_targets_are_the_next_ids():
    (batch,) = _batches(11, n=1)
    assert torch.equal(batch["targets"][:, :-1], batch["tokens"][:, 1:])


def test_the_mix_is_the_cells_size():
    traffic = gen.load(ROOT, "train-4k")
    assert (traffic["kind"], traffic["batch"], traffic["seq"]) == (
        "train", 1, 4096)
