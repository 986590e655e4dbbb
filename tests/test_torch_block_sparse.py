"""Port parity: the block-sparse (ZTB) kernel's plain version and public
wrappers against the JAX package's Pallas kernel (interpret mode) and its
jnp oracle; the CSR schedule built identically; the wrappers' device rules.
The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.

Tolerances: float32 at rtol 1e-4 / atol 1e-3 (sums of 512 products taken
in other orders); int8 operands exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import csr_block_schedule as jax_csr
from repro.core.sparsity import prune_block_structured, ztb_from_weight
from repro.kernels.block_sparse import ops as jax_ops
from repro.kernels.block_sparse.ref import (
    block_sparse_matmul_ref as jax_ref,
)
from repro_torch.core.sparsity import csr_block_schedule
from repro_torch.kernels.block_sparse import ops
from repro_torch.kernels.block_sparse.ref import block_sparse_matmul_ref


def _pruned(rng, k, n, b, sparsity, ints):
    if ints:
        w = rng.integers(-8, 9, size=(k, n)).astype(np.int8)
    else:
        w = rng.standard_normal((k, n)).astype(np.float32)
    w = prune_block_structured(w, block_k=b, block_n=b, sparsity=sparsity)
    nz = ztb_from_weight(w, block_k=b, block_n=b, window=4).tile_nonzero
    return w, np.asarray(nz.reshape(-1, n // b)[:k // b])


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.6, 0.95])
def test_ztb_matmul_matches_pallas_float32(sparsity):
    """tests/test_kernels.py's sweep shapes."""
    rng = np.random.default_rng(int(sparsity * 100))
    m, k, n, b = 128, 512, 384, 128
    w, nz = _pruned(rng, k, n, b, sparsity, ints=False)
    x = rng.standard_normal((m, k)).astype(np.float32)
    pallas = np.asarray(jax_ops.ztb_matmul(
        jnp.array(x), jnp.array(w), nz, bm=128, bn=b, bk=b,
        backend="pallas", interpret=True))
    got = ops.ztb_matmul(torch.from_numpy(x), torch.from_numpy(w), nz,
                         bm=128, bn=b, bk=b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.6, 0.95])
def test_ztb_matmul_int8_is_exact(sparsity):
    """int8 operands: the exact int32 product; the Pallas kernel's f32
    accumulation agrees because every sum stays below 2^24."""
    rng = np.random.default_rng(7 + int(sparsity * 100))
    m, k, n, b = 128, 512, 384, 128
    w, nz = _pruned(rng, k, n, b, sparsity, ints=True)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    expect = x.astype(np.int64) @ w.astype(np.int64)
    pallas = np.asarray(jax_ops.ztb_matmul(
        jnp.array(x, jnp.float32), jnp.array(w, jnp.float32), nz, bm=128,
        bn=b, bk=b, backend="pallas", interpret=True))
    got = ops.ztb_matmul(torch.from_numpy(x), torch.from_numpy(w), nz,
                         bn=b, bk=b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(pallas.astype(np.int64), expect)
    plain = block_sparse_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    nz, bk=b, bn=b)
    np.testing.assert_array_equal(plain.numpy(), expect)


def test_plain_version_masks_like_the_jnp_oracle():
    """A mask that disagrees with w's zeros: both versions zero the
    unlisted blocks (float32 at 1e-4 / 1e-3)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    nz = rng.random((4, 2)) > 0.5
    expect = np.asarray(jax_ref(jnp.array(x), jnp.array(w), nz, bk=64,
                                bn=64))
    got = block_sparse_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                  nz, bk=64, bn=64)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-3)


def test_tile_gemm_respects_caller_mask():
    """tests/test_legion_runtime.py's caller-mask case (ragged M=100, the
    whole-tile shape fallback): a supplied pruning mask zeroes blocks even
    where w is non-zero, as the reference's tile_gemm does."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((100, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    mask = np.zeros((2, 2), dtype=bool)
    mask[0, 0] = True
    expect = x[:, :128] @ (w[:128, :] * np.repeat(
        np.repeat(mask, 128, 0), 128, 1)[:128])
    pal = np.asarray(jax_ops.tile_gemm(x, w, block_nonzero=mask,
                                       backend="pallas", interpret=True))
    got = ops.tile_gemm(torch.from_numpy(x), torch.from_numpy(w),
                        block_nonzero=mask).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    # a shape the defaults do not divide: the whole-tile fallback
    xi = rng.integers(-8, 9, size=(5, 200)).astype(np.int8)
    wi = rng.integers(-8, 9, size=(200, 96)).astype(np.int8)
    wi[:100] = 0
    ref = np.asarray(jax_ops.tile_gemm(xi.astype(np.float32),
                                       wi.astype(np.float32)))
    got = ops.tile_gemm(torch.from_numpy(xi), torch.from_numpy(wi))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", range(3))
def test_csr_schedule_equal_in_both_packages(seed):
    rng = np.random.default_rng(seed)
    nz = rng.random((int(rng.integers(1, 12)), int(rng.integers(1, 9)))) \
        > rng.random()
    for a, b in zip(csr_block_schedule(nz), jax_csr(nz)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_schedule_trims_and_survives_an_all_zero_mask():
    nz = np.zeros((5, 3), dtype=bool)
    indices, counts = ops.schedule(nz, torch.device("cpu"))
    assert tuple(indices.shape) == (3, 1) and counts.tolist() == [0, 0, 0]
    x = torch.ones((4, 10), dtype=torch.int8)
    w = torch.ones((10, 7), dtype=torch.int8)
    out = torch.full((4, 7), 3, dtype=torch.int32)
    ops.block_sparse_matmul(x, w, indices, counts, bk=2, bn=3, out=out)
    assert torch.equal(out, torch.full((4, 7), 3, dtype=torch.int32))
    fresh = ops.block_sparse_matmul(x, w, indices, counts, bk=2, bn=3)
    assert torch.equal(fresh, torch.zeros((4, 7), dtype=torch.int32))


def test_block_mask_covers_ragged_edges():
    w = np.zeros((10, 7), dtype=np.int8)
    w[9, 6] = 1
    w[0, 0] = -1
    mask = ops.block_mask(w, bk=4, bn=3)
    assert mask.shape == (3, 3)
    assert mask.sum() == 2 and mask[0, 0] and mask[2, 2]
    x = np.arange(40, dtype=np.int8).reshape(4, 10)
    indices, counts = ops.schedule(mask, torch.device("cpu"))
    got = ops.block_sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  indices, counts, bk=4, bn=3)
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


def test_cpu_tensors_never_reach_the_kernel():
    x = torch.zeros((2, 4), dtype=torch.int8)
    w = torch.zeros((4, 4), dtype=torch.int8)
    nz = np.ones((1, 1), dtype=bool)
    before = dict(ops.LAUNCHES)
    ops.ztb_matmul(x, w, nz, bk=4, bn=4)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.ztb_matmul(x, w, nz, bk=4, bn=4, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.ztb_matmul(x, w, nz, bk=4, bn=4, backend="pallas")
