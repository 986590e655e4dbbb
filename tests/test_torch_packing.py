"""Port parity: repro_torch.quant.packing is byte-identical to repro's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import packing as ref
from repro_torch.quant import packing as port

CASES = [("2bit", -2, 2), ("4bit", -8, 8)]


def _both(fn, arr):
    a = np.asarray(getattr(ref, fn)(jnp.asarray(arr)))
    b = getattr(port, fn)(torch.from_numpy(arr.copy())).numpy()
    return a, b


@pytest.mark.parametrize("name,lo,hi", CASES)
@pytest.mark.parametrize("shape", [(8,), (3, 16), (2, 5, 24)])
def test_last_axis_pack_unpack_byte_identical(name, lo, hi, shape):
    rng = np.random.default_rng(len(shape) * 10 + hi)
    w = rng.integers(lo, hi, size=shape).astype(np.int8)
    w.flat[0] = lo                       # the legal extreme (-2 at 2 bits)
    a, b = _both(f"pack_{name}", w)
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    ua, ub = _both(f"unpack_{name}", a)
    assert ub.dtype == np.int8
    np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(ub, w)


@pytest.mark.parametrize("name,lo,hi", CASES)
@pytest.mark.parametrize("k,n", [(4, 1), (128, 64), (256, 96)])
def test_kmajor_pack_unpack_byte_identical(name, lo, hi, k, n):
    rng = np.random.default_rng(k + n + hi)
    w = rng.integers(lo, hi, size=(k, n)).astype(np.int8)
    w[0, 0] = lo
    a, b = _both(f"pack_{name}_kmajor", w)
    assert b.shape == (k // (8 // int(name[0])), n)
    np.testing.assert_array_equal(a, b)
    ua, ub = _both(f"unpack_{name}_kmajor", a)
    np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(ub, w)


def test_kmajor_row_order():
    """Byte (k', n) holds rows f*k'+i at bit bits*i (not interleaved by
    column)."""
    w = np.zeros((8, 2), np.int8)
    w[5, 1] = -2                          # k' = 1, i = 1 at 2 bits
    packed = port.pack_2bit_kmajor(torch.from_numpy(w)).numpy()
    assert packed[1, 1] == 0b10 << 2 and packed.sum() == packed[1, 1]


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError):
        port.pack_2bit(torch.zeros(6, dtype=torch.int8))
    with pytest.raises(ValueError):
        port.pack_4bit_kmajor(torch.zeros((3, 4), dtype=torch.int8))
