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
from repro_torch.kernels import dense_tile_gemm
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
