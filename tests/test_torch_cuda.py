"""The port's CUDA kernels against their plain versions, on the card.

This file imports no JAX (the card's machine has none); every test is
marked ``cuda`` and skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dense_tile_gemm
from repro_torch.kernels.bitlinear import ops
from repro_torch.kernels.bitlinear.ref import bitlinear_matmul_ref
from repro_torch.quant.packing import pack_2bit_kmajor, pack_4bit_kmajor

PACK = {2: pack_2bit_kmajor, 4: pack_4bit_kmajor, 8: lambda w: w}
LOHI = {2: (-2, 2), 4: (-8, 8), 8: (-128, 128)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(m, k, n, bits, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                         .astype(np.int8)).to(device)
    w = torch.from_numpy(rng.integers(*LOHI[bits], size=(k, n))
                         .astype(np.int8)).to(device)
    return x, PACK[bits](w)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 128, 64), (7, 128, 50), (1, 2560, 128),
                                   (24, 6912, 320), (3, 200, 70),
                                   (40, 2048, 864)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bitlinear_kernel_matches_plain_version(card, m, k, n, bits):
    k -= k % (8 // bits)
    x, w = _operands(m, k, n, bits, m + k + n, card)
    expect = bitlinear_matmul_ref(x, w, bits=bits)
    got = ops.tile_gemm(x, w, bits=bits)
    acc = torch.full((m, n), 5, dtype=torch.int32, device=card)
    ops.tile_gemm(x, w, bits=bits, out=acc)
    torch.cuda.synchronize()
    assert torch.equal(got, expect)
    assert torch.equal(acc, expect + 5)


@pytest.mark.cuda
def test_bitlinear_kernel_on_strided_views(card):
    """The runtime's calls: column/row windows of larger matrices."""
    x, w = _operands(5, 512, 300, 2, 11, card)
    acc = torch.zeros((2, 5, 300), dtype=torch.int32, device=card)
    before = ops.LAUNCHES[2]
    ops.tile_gemm(x[:, 128:256], w[32:64, 64:128], bits=2,
                  out=acc[1, :, 64:128])
    torch.cuda.synchronize()
    assert ops.LAUNCHES[2] == before + 1
    expect = bitlinear_matmul_ref(x[:, 128:256].contiguous(),
                                  w[32:64, 64:128].contiguous(), bits=2)
    assert torch.equal(acc[1, :, 64:128], expect)
    assert int(acc.abs().sum()) == int(expect.abs().sum())


@pytest.mark.cuda
def test_dense_int8_path_and_rejections(card):
    x, w = _operands(1, 384, 96, 8, 3, card)
    assert torch.equal(dense_tile_gemm(x, w), bitlinear_matmul_ref(x, w,
                                                                   bits=8))
    with pytest.raises(TypeError):
        dense_tile_gemm(x.to(torch.int32), w)
    with pytest.raises(ValueError, match="reference"):
        ops.tile_gemm(x, w, bits=8, backend="reference")
