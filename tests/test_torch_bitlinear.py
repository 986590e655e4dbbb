"""Port parity: the bitlinear kernel's plain version against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle, bit for bit;
the wrapper's device rules.  The CUDA kernel itself is held against the
plain version on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dense_tile_gemm as jax_dense
from repro.kernels.bitlinear import ops as jax_ops
from repro.kernels.bitlinear.kernel import bitlinear_matmul as pallas_matmul
from repro.kernels.bitlinear.ref import bitlinear_matmul_ref as jax_ref
from repro.quant.packing import pack_2bit_kmajor, pack_4bit_kmajor
from repro_torch.kernels import dense_grouped_tile_gemm, dense_tile_gemm
from repro_torch.kernels.bitlinear import ops
from repro_torch.kernels.bitlinear.ref import bitlinear_matmul_ref

PACK = {2: pack_2bit_kmajor, 4: pack_4bit_kmajor}
LOHI = {2: (-2, 2), 4: (-8, 8), 8: (-128, 128)}


def _operands(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(*LOHI[bits], size=(k, n)).astype(np.int8)
    wp = w if bits == 8 else np.array(PACK[bits](jnp.asarray(w)))
    return x, w, wp


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (256, 512, 256),
                                   (128, 1024, 384)])
@pytest.mark.parametrize("bits", [2, 4])
def test_plain_version_matches_pallas_on_sweep_shapes(m, k, n, bits):
    x, w, wp = _operands(m, k, n, bits, seed=m + k + n + bits)
    pallas = np.asarray(pallas_matmul(jnp.asarray(x), jnp.asarray(wp),
                                      bits=bits, bm=128, bn=128, bk=256,
                                      interpret=True))
    port = bitlinear_matmul_ref(torch.from_numpy(x), torch.from_numpy(wp),
                                bits=bits).numpy()
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(
        port, np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(wp), bits=bits)))


@pytest.mark.parametrize("m", [1, 7])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tile_gemm_matches_reference_on_runtime_shapes(m, bits):
    """The runtime's ragged tiles: decode M=1, K window 128, N tile 64."""
    x, w, wp = _operands(m, 128, 64, bits, seed=m * 10 + bits)
    if bits == 8:
        expect = np.asarray(jax_dense(jnp.asarray(x), jnp.asarray(w)))
        got = dense_tile_gemm(torch.from_numpy(x), torch.from_numpy(w))
    else:
        expect = np.asarray(jax_ops.tile_gemm(
            jnp.asarray(x), jnp.asarray(wp), bits=bits, backend="pallas",
            interpret=True))
        got = ops.tile_gemm(torch.from_numpy(x), torch.from_numpy(wp),
                            bits=bits)
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(
        expect, x.astype(np.int64) @ w.astype(np.int64))


def test_accumulate_into_strided_view():
    x, w, wp = _operands(3, 128, 64, 2, seed=5)
    acc = torch.ones((3, 100), dtype=torch.int32)
    view = acc[:, 20:84]
    ops.tile_gemm(torch.from_numpy(x), torch.from_numpy(wp), bits=2,
                  out=view)
    expect = 1 + x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(acc[:, 20:84].numpy(), expect)
    assert (acc[:, :20] == 1).all() and (acc[:, 84:] == 1).all()


def test_dense_tile_gemm_float_path():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 7)).astype(np.float32)
    got = dense_tile_gemm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    # f32 products summed in another order than XLA's: 1e-5 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_dense(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)


def test_backend_rules_raise_instead_of_falling_back():
    x = torch.zeros((1, 128), dtype=torch.int8)
    wp = torch.zeros((32, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cuda"):
        ops.tile_gemm(x, wp, bits=2, backend="cuda")
    with pytest.raises(ValueError):
        ops.tile_gemm(x, wp, bits=2, backend="pallas")
    with pytest.raises(ValueError, match="packed K"):
        ops.tile_gemm(x, wp[:16], bits=2)
    with pytest.raises(ValueError):
        ops.tile_gemm(x, wp, bits=3)
    assert ops.resolve_backend("auto", x) == "reference"


def _pallas_tile(x, wp, bits):
    """The JAX package's tile GEMM of one item: the Pallas kernel in
    interpret mode at bits 2/4, its dense int8 product at bits 8."""
    if bits == 8:
        return np.asarray(jax_dense(jnp.asarray(x), jnp.asarray(wp)))
    return np.asarray(jax_ops.tile_gemm(jnp.asarray(x), jnp.asarray(wp),
                                        bits=bits, backend="pallas",
                                        interpret=True))


def _stage_group(bits, seed):
    """A work list as a Legion stage builds one: per-instance activations
    and packed weights, column slices of them (strided views), a ragged
    slice and an empty one, all into one [instances, M, N] accumulator."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(2, 5, 96)).astype(np.int8)
    w = rng.integers(*LOHI[bits], size=(2, 96, 150)).astype(np.int8)
    wp = np.stack([wi if bits == 8 else np.array(PACK[bits](jnp.asarray(wi)))
                   for wi in w])
    slices = [(0, 0, 64), (0, 64, 128), (0, 128, 150), (1, 0, 70),
              (1, 70, 70)]
    return x, w, wp, slices


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_grouped_tile_gemm_matches_per_item_calls_and_pallas(bits):
    x, w, wp, slices = _stage_group(bits, seed=40 + bits)
    tx, twp = torch.from_numpy(x), torch.from_numpy(wp)
    grouped = torch.full((2, 5, 150), 3, dtype=torch.int32)
    single = grouped.clone()
    ops.grouped_tile_gemm(tx, twp, grouped, slices, bits=bits)
    for i, lo, hi in slices:
        ops.tile_gemm(tx[i], twp[i][:, lo:hi], bits=bits,
                      out=single[i, :, lo:hi])
    np.testing.assert_array_equal(grouped.numpy(), single.numpy())
    for i, lo, hi in slices:
        if hi == lo:
            continue                             # the empty slice
        pallas = _pallas_tile(x[i], np.ascontiguousarray(wp[i][:, lo:hi]),
                              bits)
        np.testing.assert_array_equal(grouped[i, :, lo:hi].numpy() - 3,
                                      pallas)
    expect = [3 + x[i].astype(np.int64) @ w[i].astype(np.int64)
              for i in range(2)]
    np.testing.assert_array_equal(grouped[0].numpy(), expect[0])
    np.testing.assert_array_equal(grouped[1, :, :70].numpy(),
                                  expect[1][:, :70])
    assert (grouped[1, :, 70:] == 3).all()


def test_grouped_tile_gemm_shared_operands_and_overlap():
    """Shared activations and weights (no instance axis), strided views of
    wider matrices, and slices that write the same outputs: they add up,
    as one call after another would (the kernel adds with atomics)."""
    x, _, wp, _ = _stage_group(2, seed=9)
    wide_x = torch.zeros((5, 128), dtype=torch.int8)
    wide_x[:, 16:112] = torch.from_numpy(x[0])
    tw = torch.from_numpy(wp[0])
    acc = torch.zeros((2, 5, 64), dtype=torch.int32)
    ops.grouped_tile_gemm(wide_x[:, 16:112], tw[:, :64], acc,
                          [(0, 0, 64), (0, 0, 64), (1, 10, 40)], bits=2)
    once = _pallas_tile(x[0], np.ascontiguousarray(wp[0][:, :64]), 2)
    np.testing.assert_array_equal(acc[0].numpy(), 2 * once)
    np.testing.assert_array_equal(acc[1, :, 10:40].numpy(), once[:, 10:40])
    assert not acc[1, :, :10].any() and not acc[1, :, 40:].any()


def test_grouped_tile_gemm_rules():
    x = torch.zeros((1, 128), dtype=torch.int8)
    wp = torch.zeros((32, 64), dtype=torch.uint8)
    out = torch.zeros((1, 1, 64), dtype=torch.int32)
    ops.grouped_tile_gemm(x, wp, out, [], bits=2)       # nothing to do
    with pytest.raises(ValueError, match="packed K"):
        ops.grouped_tile_gemm(x, wp[:16], out, [(0, 0, 64)], bits=2)
    with pytest.raises(ValueError, match="match"):
        ops.grouped_tile_gemm(x, wp[:, :32], out, [(0, 0, 32)], bits=2)
    with pytest.raises(ValueError, match="outside"):
        ops.grouped_tile_gemm(x, wp, out, [(1, 0, 64)], bits=2)
    with pytest.raises(ValueError, match="outside"):
        ops.grouped_tile_gemm(x, wp, out, [(0, 32, 65)], bits=2)
    with pytest.raises(ValueError, match="cuda"):
        ops.grouped_tile_gemm(x, wp, out, [(0, 0, 64)], bits=2,
                              backend="cuda")
    with pytest.raises(ValueError):
        ops.grouped_tile_gemm(x, wp, out, [(0, 0, 64)], bits=3)
    with pytest.raises(TypeError):
        dense_grouped_tile_gemm(x.float(), wp, out, [(0, 0, 64)])


@pytest.mark.parametrize("bits", [2, 4])
def test_bitlinear_apply_matches_jax(bits):
    """The full serving op (quantize the activations, integer GEMM,
    dequantize) against the JAX package's: the activations' int8 codes and
    the int32 product are exact; the float output is within float32
    rounding of the dequantization (rtol 1e-6)."""
    rng = np.random.default_rng(bits)
    m, k, n = 16, 256, 96
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(*LOHI[bits], size=(k, n)).astype(np.int8)
    wp = np.array(PACK[bits](jnp.asarray(w)))
    scale = np.float32(0.037)
    want = np.asarray(jax_ops.bitlinear_apply(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(scale), bits=bits))
    tx = torch.from_numpy(x)
    got = ops.bitlinear_apply(tx, torch.from_numpy(wp),
                              torch.tensor(scale), bits=bits)
    # the integer part: the same codes and the exact int32 product
    s = np.max(np.abs(x), axis=-1, keepdims=True) / 127.0 + 1e-5
    xq = np.clip(np.round(x / s), -128, 127).astype(np.int8)
    ts = torch.amax(tx.abs(), dim=-1, keepdim=True) / 127.0 + 1e-5
    txq = torch.clamp(torch.round(tx / ts), -128, 127).to(torch.int8)
    np.testing.assert_array_equal(txq.numpy(), xq)
    acc = ops.bitlinear_matmul(txq, torch.from_numpy(wp), bits=bits)
    np.testing.assert_array_equal(acc.numpy(),
                                  xq.astype(np.int32) @ w.astype(np.int32))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
