"""Port parity: the flash-attention plain version and wrapper
(repro_torch.kernels.flash_attention) against the JAX package's Pallas
kernel in interpret mode, on the same seeded inputs.

Tolerances are the JAX package's own (tests/test_kernels.py): float32
rtol 2e-4 / atol 2e-5 (full softmax against the online one, summed in
another order), bfloat16 2e-2 (outputs rounded to bf16 on both sides); the
gradients against ``jax.vjp`` of ``_flash_ref`` (the custom VJP the JAX
model trains through) rtol 2e-3 / atol 2e-4, as its own test
(``test_flash_custom_vjp_grads``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import _flash_fwd_impl, _flash_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_fwd_ref, attention_ref,
)

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=2e-3, atol=2e-4)


def _qkv(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_kernel_f32(h, hkv, causal):
    arrays = _qkv(2, h, hkv, 256, 256, 32, h * 10 + hkv)
    want = jax_flash(*map(jnp.asarray, arrays), causal=causal,
                     backend="pallas", interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_matches_pallas_kernel_bf16():
    arrays = _qkv(1, 2, 2, 128, 128, 64, 3)
    want = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                     backend="pallas", interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in arrays))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_112(causal):
    """Zamba2-7B's head dimension, which is not a power of two."""
    arrays = _qkv(1, 4, 2, 128, 128, 112, 7)
    want = jax_flash(*map(jnp.asarray, arrays), causal=causal,
                     backend="pallas", interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_causal_convention_when_lengths_differ():
    """Sq != Sk: the port follows the Pallas kernel (top-left,
    q position >= k position); the JAX reference aligns bottom-right."""
    q, k, v = _qkv(1, 2, 2, 128, 256, 32, 11)
    flat = lambda a, h: a.reshape(h, *a.shape[2:])       # noqa: E731
    want = pallas(*(jnp.asarray(flat(a, 2)) for a in (q, k, v)),
                  q_heads=2, kv_heads=2, causal=True, interpret=True)
    got = attention_ref(*(torch.from_numpy(flat(a, 2)) for a in (q, k, v)),
                        q_heads=2, kv_heads=2, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    bottom_right = jax_ref(*(jnp.asarray(flat(a, 2)) for a in (q, k, v)),
                           q_heads=2, kv_heads=2, causal=True)
    assert np.abs(got.numpy() - np.asarray(bottom_right)).max() > 0.1


def test_strided_views_and_ragged_lengths():
    """[B, S, H, d] tensors handed over as [B, H, S, d] views (the attention
    layer's call), at lengths no tile size divides."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 77, h, 16)).astype(
        np.float32)).transpose(1, 2) for h in (4, 2, 2))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jax_want = jax_ref(*(jnp.asarray(t.contiguous().reshape(-1, 77, 16))
                         for t in (q, k, v)), q_heads=4, kv_heads=2)
    np.testing.assert_allclose(got.reshape(-1, 77, 16).numpy(),
                               np.asarray(jax_want), **F32)


def test_wrapper_refuses_bad_calls():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 16, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :1].expand(1, 3, 16, 8), v)   # 4 % 3
    assert ops.LAUNCHES == {
        "float32": 0, "bfloat16": 0, "lse_float32": 0, "lse_bfloat16": 0,
        "backward_float32": 0, "backward_bfloat16": 0}


@pytest.mark.parametrize("shape,strides,ptr,why", [
    # the attention layer's call: [B, S, H, d] memory as a [B, H, S, d] view
    ((1, 32, 4096, 112), (4096 * 32 * 112, 112, 32 * 112, 1), 0, None),
    ((2, 8, 64, 64), (8 * 64 * 64, 64 * 64, 64, 1), 4096, None),
    ((1, 4, 30, 100), (12000, 100, 400, 1), 0, "d=100"),
    ((1, 4, 30, 112), (3360, 112, 452, 1), 0, "position stride"),
    ((1, 3, 30, 112), (13440, 113, 336, 1), 0, "head stride"),
    ((2, 4, 30, 112), (13441, 112 * 30, 112, 1), 0, "batch stride"),
    # an axis of extent 1 is never stepped along: its stride is free
    ((1, 1, 30, 112), (13441, 7, 112, 1), 0, None),
    ((1, 4, 30, 112), (13440, 3360, 112, 1), 8, "16-byte aligned"),
])
def test_tma_layout_rules(shape, strides, ptr, why):
    """The bf16 kernel's TMA operand rules: 16-byte aligned base, rows and
    byte strides that are multiples of 16 (d % 8 == 0 in bf16)."""
    got = ops.tma_layout_error(shape, strides, ptr)
    if why is None:
        assert got is None
    else:
        assert why in got


def test_tma_layout_rules_on_tensor_views():
    """Views as torch makes them: the layer's transposed [B, S, H, d]
    tensors pass; a head dimension cut to 100 or a view one element into
    its storage does not."""
    base = torch.zeros((2, 30, 4, 128), dtype=torch.bfloat16)
    good = base[..., :112].transpose(1, 2)
    assert ops.tma_layout_error(good.shape, good.stride(),
                                good.data_ptr()) is None
    cut = base[..., :100].transpose(1, 2)
    assert "d=100" in ops.tma_layout_error(cut.shape, cut.stride(),
                                           cut.data_ptr())
    shifted = base[..., 1:113].transpose(1, 2)
    assert "aligned" in ops.tma_layout_error(
        shifted.shape, shifted.stride(), shifted.data_ptr())


def _bshd(b, s, h, hkv, d, seed):
    """q [B, S, H, d], k / v [B, S, Hkv, d] and an output gradient, the
    layout of the JAX model's ``_flash_ref``."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, heads, d)).astype(np.float32)
                 for heads in (h, hkv, hkv, h))


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_against_jax_custom_vjp(h, hkv, causal):
    """``attention_fwd_ref``'s lse and ``attention_bwd_ref``, and the flash
    Function's CPU backward through autograd, against ``jax.vjp`` of
    ``_flash_ref`` (tiles of 64 queries x 32 keys) on the same values."""
    b, s, d = 2, 128, 16
    q, k, v, g = _bshd(b, s, h, hkv, d, h * 10 + hkv + causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, vjp = jax.vjp(lambda *a: _flash_ref(*a, causal=causal, bq=64,
                                             bk=32), jq, jk, jv)
    dq, dk, dv = vjp(jnp.asarray(g))
    # JAX's lse [b, hkv, group, s] is [b, h, s] with h = hk * group + i
    _, jlse = _flash_fwd_impl(jq, jk, jv, 0, causal, 64, 32)

    def flat(a):           # [B, S, heads, d] -> [B*heads, S, d]
        return torch.from_numpy(a).transpose(1, 2).reshape(-1, s, d)

    def bshd(t, heads):    # and back
        return t.reshape(b, heads, s, d).transpose(1, 2).numpy()

    kw = dict(q_heads=h, kv_heads=hkv, causal=causal)
    o, lse = attention_fwd_ref(flat(q), flat(k), flat(v), **kw)
    np.testing.assert_allclose(bshd(o, h), np.asarray(out), **F32)
    np.testing.assert_allclose(lse.reshape(b, h, s).numpy(),
                               np.asarray(jlse).reshape(b, h, s), **F32)
    grads = attention_bwd_ref(flat(q), flat(k), flat(v), o, lse, flat(g),
                              **kw)
    for got, heads, want in zip(grads, (h, hkv, hkv), (dq, dk, dv)):
        np.testing.assert_allclose(bshd(got, heads), np.asarray(want),
                                   **GRAD)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    # the attention layer's call: [B, S, H, d] tensors as [B, H, S, d] views
    to = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2), causal=causal)
    to.transpose(1, 2).backward(torch.from_numpy(g))
    np.testing.assert_allclose(to.detach().transpose(1, 2).numpy(),
                               np.asarray(out), **F32)
    for got, want in zip((tq.grad, tk.grad, tv.grad), (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


def test_function_only_under_autograd():
    """The serve path (no gradient wanted) returns a tensor without a
    ``grad_fn``; with one it goes through ``FlashAttention``, whose
    gradients equal autograd through the plain forward."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _bshd(1, 64, 4, 2, 8, 3)[:3])
    assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.square().sum().backward()
    want_q = q.detach().clone().requires_grad_()
    attention_ref(want_q.reshape(4, 64, 8), k.reshape(2, 64, 8),
                  v.reshape(2, 64, 8), q_heads=4, kv_heads=2
                  ).square().sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), want_q.grad.numpy(), **GRAD)


@pytest.mark.parametrize("q_offset,causal", [(0, True), (64, True),
                                              (192, True), (37, True),
                                              (100, False)])
def test_query_offset_against_jax(q_offset, causal):
    """A shard of 64 queries at positions q_offset.. against 256 keys: the
    plain forward (with its lse), the plain backward and the flash
    Function's CPU path under autograd against ``_flash_ref(...,
    q_offset=...)`` and its ``jax.vjp`` (q_offset takes no gradient), at
    flash's float32 tolerances."""
    b, sq, sk, h, hkv, d = 1, 64, 256, 4, 2, 16
    rng = np.random.default_rng(q_offset + causal)
    q, g = (rng.standard_normal((b, sq, h, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, vjp = jax.vjp(lambda *a: _flash_ref(*a, causal=causal, bq=32,
                                             bk=32, q_offset=q_offset),
                       jq, jk, jv)
    dq, dk, dv = vjp(jnp.asarray(g))
    _, jlse = _flash_fwd_impl(jq, jk, jv, q_offset, causal, 32, 32)

    def flat(a):           # [B, S, heads, d] -> [B*heads, S, d]
        return torch.from_numpy(a).transpose(1, 2).reshape(-1, a.shape[1], d)

    kw = dict(q_heads=h, kv_heads=hkv, causal=causal, q_offset=q_offset)
    o, lse = attention_fwd_ref(flat(q), flat(k), flat(v), **kw)
    np.testing.assert_allclose(
        o.reshape(b, h, sq, d).transpose(1, 2).numpy(), np.asarray(out),
        **F32)
    np.testing.assert_allclose(lse.reshape(b, h, sq).numpy(),
                               np.asarray(jlse).reshape(b, h, sq), **F32)
    plain = attention_ref(flat(q), flat(k), flat(v), **kw)
    np.testing.assert_allclose(plain.numpy(), o.numpy(), **F32)
    grads = attention_bwd_ref(flat(q), flat(k), flat(v), o, lse, flat(g),
                              **kw)
    for got, want in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(
            got.reshape(b, -1, got.shape[1], d).transpose(1, 2).numpy(),
            np.asarray(want), **GRAD)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2), causal=causal,
                             q_offset=q_offset)
    to.transpose(1, 2).backward(torch.from_numpy(g))
    np.testing.assert_allclose(to.detach().transpose(1, 2).numpy(),
                               np.asarray(out), **F32)
    for got, want in zip((tq.grad, tk.grad, tv.grad), (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)


def test_query_offset_shards_join_to_the_whole_sequence():
    """Four query shards at offsets 0, 64, 128, 192 of a causal 256-token
    sequence, each against the whole keys, give the whole call's output
    rows; the wrapper refuses an offset that is not an int >= 0."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 256, 256, 16, 5))
    whole = ops.flash_attention(q, k, v, causal=True)
    parts = [ops.flash_attention(q[:, :, r:r + 64], k, v, causal=True,
                                 q_offset=r) for r in range(0, 256, 64)]
    np.testing.assert_allclose(torch.cat(parts, dim=2).numpy(),
                               whole.numpy(), **F32)
    for bad in (-1, True, 1.5):
        with pytest.raises(ValueError, match="q_offset"):
            ops.flash_attention(q, k, v, q_offset=bad)
