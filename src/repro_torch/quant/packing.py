"""Sub-byte weight packing — the storage format behind the R=4/R=2 modes.

D-Legion feeds 2-bit (ternary) or 4-bit weights to its reconfigurable PEs.
On the GPU the equivalent win is bandwidth: weights live in device memory
packed 4-per-byte (2-bit) or 2-per-byte (4-bit) and are unpacked on chip
inside the bitlinear CUDA kernel.  Torch uint8 bit operations, byte-identical
to the JAX package's ``repro.quant.packing``.

Encodings (two's complement within the field):
    2-bit: -1 -> 0b11, 0 -> 0b00, +1 -> 0b01   (value -2 is legal but unused)
    4-bit: [-8, 7]
"""
from __future__ import annotations

import torch


def _fields(w: torch.Tensor, bits: int) -> torch.Tensor:
    """int values -> their low ``bits`` two's-complement field, as uint8."""
    return torch.bitwise_and(w.to(torch.int16), (1 << bits) - 1).to(torch.uint8)


def _sign_extend(v: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 fields in [0, 2^bits) -> int8 two's-complement values."""
    v = v.to(torch.int8)
    return v - torch.bitwise_left_shift(
        torch.bitwise_and(v, 1 << (bits - 1)), 1)


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(0, 8, bits, dtype=torch.uint8, device=device)


def _pack_axis(u: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Combine the ``8 // bits`` fields along ``axis`` (field i at bit
    ``bits * i``) into one byte."""
    shape = [1] * u.ndim
    shape[axis] = 8 // bits
    shifted = torch.bitwise_left_shift(u, _shifts(bits, u.device).view(shape))
    out = shifted.select(axis, 0).clone()
    for i in range(1, 8 // bits):
        out |= shifted.select(axis, i)
    return out


def pack_2bit(w: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-2, 1] 4-per-byte along the last axis.

    Element j*4+i sits in byte j at bit 2*i.
    """
    if w.shape[-1] % 4:
        raise ValueError(f"last axis {w.shape[-1]} not divisible by 4")
    u = _fields(w, 2).reshape(*w.shape[:-1], w.shape[-1] // 4, 4)
    return _pack_axis(u, 2, u.ndim - 1)


def unpack_2bit(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_2bit` -> int8 [..., K*4]."""
    vals = torch.bitwise_and(
        torch.bitwise_right_shift(packed[..., None], _shifts(2, packed.device)),
        3)
    return _sign_extend(vals, 2).reshape(*packed.shape[:-1],
                                         packed.shape[-1] * 4)


def pack_4bit(w: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] 2-per-byte (low nibble first)."""
    if w.shape[-1] % 2:
        raise ValueError(f"last axis {w.shape[-1]} not divisible by 2")
    u = _fields(w, 4).reshape(*w.shape[:-1], w.shape[-1] // 2, 2)
    return _pack_axis(u, 4, u.ndim - 1)


def unpack_4bit(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_4bit` -> int8 [..., K*2]."""
    vals = torch.bitwise_and(
        torch.bitwise_right_shift(packed[..., None], _shifts(4, packed.device)),
        15)
    return _sign_extend(vals, 4).reshape(*packed.shape[:-1],
                                         packed.shape[-1] * 2)


# --------------------------------------------------------------------------- #
# K-major packing — the layout the bitlinear kernel reads.
#
# Packing a weight matrix [K, N] along K keeps N contiguous, so neighbouring
# threads read neighbouring columns, and one 2-bit byte unpacks into the four
# consecutive K values of one int8 MMA fragment register.
# --------------------------------------------------------------------------- #

def _pack_kmajor(w: torch.Tensor, bits: int) -> torch.Tensor:
    factor = 8 // bits
    k, n = w.shape
    if k % factor:
        raise ValueError(f"K={k} not divisible by {factor}")
    return _pack_axis(_fields(w, bits).reshape(k // factor, factor, n), bits, 1)


def _unpack_kmajor(packed: torch.Tensor, bits: int) -> torch.Tensor:
    kq, n = packed.shape
    vals = torch.bitwise_and(
        torch.bitwise_right_shift(packed[:, None, :],
                                  _shifts(bits, packed.device)[None, :, None]),
        (1 << bits) - 1)
    return _sign_extend(vals, bits).reshape(kq * (8 // bits), n)


def pack_2bit_kmajor(w: torch.Tensor) -> torch.Tensor:
    """Pack int8 [K, N] (values in [-2, 1]) -> uint8 [K // 4, N].

    Byte (k', n) holds rows 4*k' .. 4*k'+3 of column n, row i at bit 2*i.
    """
    return _pack_kmajor(w, 2)


def unpack_2bit_kmajor(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_2bit_kmajor` -> int8 [K, N]."""
    return _unpack_kmajor(packed, 2)


def pack_4bit_kmajor(w: torch.Tensor) -> torch.Tensor:
    """Pack int8 [K, N] (values in [-8, 7]) -> uint8 [K // 2, N]."""
    return _pack_kmajor(w, 4)


def unpack_4bit_kmajor(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_4bit_kmajor` -> int8 [K, N]."""
    return _unpack_kmajor(packed, 4)


def pack(w: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 2:
        return pack_2bit(w)
    if bits == 4:
        return pack_4bit(w)
    if bits == 8:
        return w.to(torch.int8)
    raise ValueError(f"bits={bits}")


def unpack(packed: torch.Tensor, bits: int) -> torch.Tensor:
    if bits == 2:
        return unpack_2bit(packed)
    if bits == 4:
        return unpack_4bit(packed)
    if bits == 8:
        return packed.to(torch.int8)
    raise ValueError(f"bits={bits}")
