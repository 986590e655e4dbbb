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


# --------------------------------------------------------------------------- #
# block-sparse (ZTB): int8 exactly; float32 at rtol 1e-4 / atol 1e-3 (sums
# taken in another order than the plain version's matmul)
# --------------------------------------------------------------------------- #

def _sparse_operands(m, k, n, bk, bn, sparsity, dtype, seed, device):
    from repro_torch.kernels.block_sparse import ops as bs_ops

    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
        w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
    kt, nt = -(-k // bk), -(-n // bn)
    keep = rng.random((kt, nt)) >= sparsity
    w = w * np.repeat(np.repeat(keep, bk, 0), bn, 1)[:k, :n].astype(w.dtype)
    mask = bs_ops.block_mask(w, bk=bk, bn=bn)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device),
            mask)


def _assert_close(got, expect):
    if got.dtype == torch.int32:
        assert torch.equal(got, expect)
    else:
        torch.testing.assert_close(got, expect, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bk,bn", [
    (512, 2560, 128, 128, 64), (512, 2048, 320, 128, 64),
    (16, 1024, 512, 128, 64), (5, 200, 70, 32, 16), (100, 256, 256, 128, 128),
    (33, 96, 200, 96, 200)])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_block_sparse_kernel_matches_plain_version(card, m, k, n, bk, bn,
                                                   sparsity, dtype):
    from repro_torch.kernels.block_sparse import ops as bs_ops
    from repro_torch.kernels.block_sparse.ref import block_sparse_matmul_ref

    x, w, mask = _sparse_operands(m, k, n, bk, bn, sparsity, dtype,
                                  m + k + n, card)
    expect = block_sparse_matmul_ref(x, w, mask, bk=bk, bn=bn)
    before = bs_ops.LAUNCHES[str(dtype).split(".")[1]]
    got = bs_ops.ztb_matmul(x, w, mask, bk=bk, bn=bn)
    acc = torch.full_like(expect, 5)
    bs_ops.ztb_matmul(x, w, mask, bk=bk, bn=bn, out=acc)
    torch.cuda.synchronize()
    assert bs_ops.LAUNCHES[str(dtype).split(".")[1]] == before + 2
    _assert_close(got, expect)
    _assert_close(acc, expect + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_block_sparse_kernel_on_strided_views(card, dtype):
    """The Machine's calls: an instance's column slice of the padded
    weights, rows of the padded activations, a slice of the output."""
    from repro_torch.kernels.block_sparse import ops as bs_ops
    from repro_torch.kernels.block_sparse.ref import block_sparse_matmul_ref

    x, w, _ = _sparse_operands(7, 512, 300, 128, 64, 0.5, dtype, 11, card)
    ws = w[:, 64:250]
    mask = bs_ops.block_mask(ws.cpu().numpy(), bk=128, bn=64)
    indices, counts = bs_ops.schedule(mask, card)
    out_dtype = torch.int32 if dtype == torch.int8 else torch.float32
    acc = torch.zeros((2, 7, 300), dtype=out_dtype, device=card)
    bs_ops.block_sparse_matmul(x, ws, indices, counts, bk=128, bn=64,
                               out=acc[1, :, 64:250])
    torch.cuda.synchronize()
    expect = block_sparse_matmul_ref(x, ws.contiguous(), mask, bk=128,
                                     bn=64)
    _assert_close(acc[1, :, 64:250], expect)
    assert not acc[0].any() and not acc[1, :, :64].any() \
        and not acc[1, :, 250:].any()


@pytest.mark.cuda
def test_block_sparse_kernel_all_zero_schedule(card):
    """No non-zero block anywhere (all experts skipped): the kernel still
    launches, writes zeros, and leaves an accumulator untouched."""
    from repro_torch.kernels.block_sparse import ops as bs_ops

    x = torch.ones((16, 1024), dtype=torch.int8, device=card)
    w = torch.zeros((1024, 512), dtype=torch.int8, device=card)
    mask = np.zeros((8, 8), dtype=bool)
    before = bs_ops.LAUNCHES["int8"]
    fresh = bs_ops.ztb_matmul(x, w, mask, bk=128, bn=64)
    acc = torch.full((16, 512), 7, dtype=torch.int32, device=card)
    bs_ops.ztb_matmul(x, w, mask, bk=128, bn=64, out=acc)
    torch.cuda.synchronize()
    assert bs_ops.LAUNCHES["int8"] == before + 2
    assert not fresh.any() and bool((acc == 7).all())


@pytest.mark.cuda
def test_block_sparse_kernel_rejections(card):
    from repro_torch.kernels.block_sparse import ops as bs_ops

    x, w, mask = _sparse_operands(8, 256, 128, 128, 64, 0.0, torch.int8, 1,
                                  card)
    with pytest.raises(TypeError):
        bs_ops.ztb_matmul(x.to(torch.int32), w.to(torch.int32), mask,
                          bk=128, bn=64)
    with pytest.raises(TypeError):
        bs_ops.ztb_matmul(x, w.float(), mask, bk=128, bn=64)
    with pytest.raises(TypeError):
        bs_ops.ztb_matmul(x, w, mask, bk=128, bn=64,
                          out=torch.zeros((8, 128), device=card))
    with pytest.raises(ValueError, match="device"):
        bs_ops.ztb_matmul(x, w.cpu(), mask, bk=128, bn=64)
    with pytest.raises(ValueError, match="stride"):
        bs_ops.ztb_matmul(x, w.t().contiguous().t(), mask, bk=128, bn=64)
    with pytest.raises(ValueError, match="reference"):
        bs_ops.ztb_matmul(x, w, mask, bk=128, bn=64, backend="reference")
