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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 8, 9, 24, 33])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bitlinear_fragment_layout_rows(card, m, bits):
    """Activation rows fill the MMA's 8-wide side: every row count around
    its multiples, a ragged K (not a multiple of the 64-deep stage) and a
    ragged N (not a multiple of the 128-column tile)."""
    x, w = _operands(m, 264, 200, bits, 100 * m + bits, card)
    expect = bitlinear_matmul_ref(x, w, bits=bits)
    acc = torch.full((m, 200), -3, dtype=torch.int32, device=card)
    ops.tile_gemm(x, w, bits=bits, out=acc)
    got = ops.tile_gemm(x, w, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, expect)
    assert torch.equal(acc, expect - 3)


def _work_list(bits, m, k, instances, n_slices, shared_x, seed, device):
    """A stage's operands as the Machine hands them over: activations
    (shared, or one matrix per instance), packed weights [instances, K',
    320], and ``n_slices`` column slices of random width 0..300 (ragged,
    empty, overlapping), every other one 16-byte aligned."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(
        -128, 128, size=(m, k) if shared_x else (instances, m, k))
        .astype(np.int8)).to(device)
    w = torch.from_numpy(rng.integers(*LOHI[bits], size=(instances, k, 320))
                         .astype(np.int8)).to(device)
    wp = torch.stack([PACK[bits](wi) for wi in w])
    slices = []
    for s in range(n_slices):
        n = int(rng.integers(0, 301))
        lo = int(rng.integers(0, 321 - n))
        if s % 2:
            lo -= lo % 16
        slices.append((int(rng.integers(instances)), lo, lo + n))
    return x, wp, slices


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,instances,n_slices,shared_x", [
    (1, 6912, 2, 6, True),       # few tiles, long K: split over blocks
    (24, 256, 40, 40, False),    # at most four K stages: no split
    (3, 3000, 16, 130, False),   # K rows not 16-byte aligned, large list
    (9, 192, 8, 420, True)])     # beyond one launch's 400 slices
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_grouped_bitlinear_kernel_matches_plain_version(
        card, bits, m, k, instances, n_slices, shared_x):
    from repro_torch.kernels.bitlinear.ref import grouped_tile_gemm_ref

    x, wp, slices = _work_list(bits, m, k, instances, n_slices, shared_x,
                               m + n_slices + bits, card)
    acc = torch.from_numpy(np.random.default_rng(n_slices).integers(
        -9, 9, size=(instances, m, 320)).astype(np.int32)).to(card)
    expect = acc.clone()
    grouped_tile_gemm_ref(x, wp, expect, slices, bits=bits)
    before = ops.LAUNCHES[bits]
    ops.grouped_tile_gemm(x, wp, acc, slices, bits=bits)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[bits] == before + -(-n_slices // 400)
    assert torch.equal(acc, expect)


@pytest.mark.cuda
def test_grouped_bitlinear_overlap_and_fresh_split(card):
    """Overlapping slices add up; a fresh (non-accumulating) decode GEMV
    long enough to split over blocks starts from zero."""
    x, w = _operands(1, 2560, 864, 2, 21, card)
    expect = bitlinear_matmul_ref(x, w, bits=2)
    acc = torch.zeros((1, 1, 864), dtype=torch.int32, device=card)
    before = ops.LAUNCHES[2]
    ops.grouped_tile_gemm(x, w, acc, [(0, 0, 864), (0, 0, 864)], bits=2)
    fresh = ops.bitlinear_matmul(x, w, bits=2)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[2] == before + 2
    assert torch.equal(acc[0], 2 * expect) and torch.equal(fresh, expect)


@pytest.mark.cuda
def test_grouped_bitlinear_odd_offsets(card):
    """Views whose rows are not 16-byte aligned take the register path."""
    x, w = _operands(5, 640, 300, 2, 17, card)
    acc = torch.zeros((1, 5, 301), dtype=torch.int32, device=card)
    xv, wv, out = x[:, 4:132], w[1:33, 3:300], acc[:, :, 1:298]
    ops.grouped_tile_gemm(xv, wv, out, [(0, 0, 127), (0, 130, 297)], bits=2)
    torch.cuda.synchronize()
    expect = bitlinear_matmul_ref(xv.contiguous(), wv.contiguous(), bits=2)
    assert torch.equal(out[0, :, :127], expect[:, :127])
    assert torch.equal(out[0, :, 130:], expect[:, 130:])
    assert not acc[0, :, 0].any() and not acc[0, :, 128:131].any()


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
@pytest.mark.parametrize("m", [16, 512])
@pytest.mark.parametrize("k,n,bk,bn", [(1000, 200, 96, 40),
                                       (1000, 190, 100, 72)])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 1.0])
def test_block_sparse_int8_ragged_blocks(card, m, k, n, bk, bn, sparsity):
    """int8 exactly, with blocks that divide neither K nor N (bk = 100 is
    no multiple of 16: x is staged through registers), one column per
    block at bn <= 64 and at 64 < bn <= 128."""
    from repro_torch.kernels.block_sparse import ops as bs_ops
    from repro_torch.kernels.block_sparse.ref import block_sparse_matmul_ref

    x, w, mask = _sparse_operands(m, k, n, bk, bn, sparsity, torch.int8,
                                  m + bk + bn, card)
    expect = block_sparse_matmul_ref(x, w, mask, bk=bk, bn=bn)
    before = bs_ops.LAUNCHES["int8"]
    got = bs_ops.ztb_matmul(x, w, mask, bk=bk, bn=bn)
    acc = torch.full_like(expect, -4)
    bs_ops.ztb_matmul(x, w, mask, bk=bk, bn=bn, out=acc)
    torch.cuda.synchronize()
    assert bs_ops.LAUNCHES["int8"] == before + 2
    assert torch.equal(got, expect) and torch.equal(acc, expect - 4)


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


# --------------------------------------------------------------------------- #
# SSD scan: against the per-step recurrence on the card, rtol / atol 1e-4
# (float32 summed in another order)
# --------------------------------------------------------------------------- #

def _ssd_operands(nb, nh, s, n, p, seed, device, shared=True):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.2, size=(nb, nh, s)).astype(np.float32)
    a = -np.exp(rng.standard_normal((1, nh, 1))).astype(np.float32)
    x = rng.standard_normal((nb, nh, s, p)).astype(np.float32)
    bh = 1 if shared else nh
    b = rng.standard_normal((nb, bh, s, n)).astype(np.float32)
    c = rng.standard_normal((nb, bh, s, n)).astype(np.float32)
    dev = lambda t: torch.from_numpy(t).to(device)         # noqa: E731
    return (dev(dt * a), dev(x * dt[..., None]),
            dev(b).expand(nb, nh, s, n), dev(c).expand(nb, nh, s, n))


def _ssd_naive(dta, dtx, b, c):
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    nb, nh, s, p = dtx.shape
    flat = lambda t: t.reshape(nb * nh, s, -1)             # noqa: E731
    y, h = ssd_scan_ref(dta.reshape(nb * nh, s), flat(dtx), flat(b),
                        flat(c), return_state=True)
    return y.reshape(nb, nh, s, p), h.reshape(nb, nh, -1, p)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nh,s,n,p,chunk", [
    (1, 3, 128, 16, 32, 32), (2, 5, 100, 40, 48, 32), (1, 112, 23, 64, 64, 23),
    (1, 4, 300, 128, 64, 128), (2, 2, 7, 8, 8, 128), (1, 2, 64, 16, 16, 1),
    # long prompts over many chunks, the last one ragged, N = 64 and 128
    (1, 3, 4096, 64, 64, 128), (1, 2, 4000, 128, 64, 128),
    (2, 2, 1001, 128, 64, 96)])
@pytest.mark.parametrize("shared", [True, False])
def test_ssd_kernel_matches_recurrence(card, nb, nh, s, n, p, chunk, shared):
    from repro_torch.kernels.ssd import ops as ssd_ops

    dta, dtx, b, c = _ssd_operands(nb, nh, s, n, p, s + n + p, card, shared)
    before = ssd_ops.LAUNCHES["float32"]
    y, h = ssd_ops.ssd(dta, dtx, b, c, chunk=min(chunk, s),
                       return_state=True)
    y_only = ssd_ops.ssd(dta, dtx, b, c, chunk=min(chunk, s))
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["float32"] == before + 2
    y_ref, h_ref = _ssd_naive(dta, dtx, b, c)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(y_only, y)


@pytest.mark.cuda
def test_ssd_kernel_flat_layout_and_strided_views(card):
    """The JAX package's [BH, S, ...] layout, and [B, S, H, P] memory handed
    over as a [B, H, S, P] view (as the model does), agree with the chunked
    plain version."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    dta, dtx, b, c = _ssd_operands(1, 6, 256, 32, 64, 3, card, shared=False)
    flat = [t[0] for t in (dta, dtx, b, c)]
    y, h = ssd_ops.ssd(*flat, chunk=64, return_state=True)
    y_ref, h_ref = ssd_chunked_ref(*flat, chunk=64, return_state=True)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_ref, rtol=1e-4, atol=1e-4)
    dtx_v = dtx.transpose(1, 2).contiguous().transpose(1, 2)
    assert not dtx_v.is_contiguous()
    y_v = ssd_ops.ssd(dta, dtx_v, b, c, chunk=64)
    torch.testing.assert_close(y_v[0], y, rtol=0, atol=0)


@pytest.mark.cuda
def test_ssd_kernel_rejections(card):
    from repro_torch.kernels.ssd import ops as ssd_ops

    dta, dtx, b, c = _ssd_operands(1, 2, 32, 8, 8, 1, card)
    with pytest.raises(TypeError):
        ssd_ops.ssd(dta, dtx.double(), b, c, chunk=32)
    with pytest.raises(TypeError):
        ssd_ops.ssd(dta, dtx, b.to(torch.bfloat16), c, chunk=32)
    with pytest.raises(ValueError, match="device"):
        ssd_ops.ssd(dta, dtx, b.cpu(), c, chunk=32)
    with pytest.raises(ValueError, match="stride"):
        ssd_ops.ssd(dta, dtx.transpose(2, 3).contiguous().transpose(2, 3),
                    b, c, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(dta, dtx, b, c, chunk=256)
    with pytest.raises(ValueError, match="CPU"):
        ssd_ops.ssd(dta, dtx, b, c, backend="reference")
    with pytest.raises(ValueError, match="CPU"):
        ssd_ops.ssd(dta, dtx, b, c, backend="naive")


# --------------------------------------------------------------------------- #
# SSD backward: against the plain closed form on the card, rtol 1e-4 / atol
# 1e-5 * max|g| (float32 summed in another order), bit-equal across calls
# --------------------------------------------------------------------------- #

def _ssd_bwd_plain(dta, dtx, b, c, dy, chunk, dh):
    """ssd_chunked_bwd_ref over [B, H, S, ...], dB and dC summed over the
    heads where b and c are [B, S, N]."""
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    nb, nh, s, p = dtx.shape
    b4, c4 = (t[:, None].expand(nb, nh, *t.shape[1:]) if t.ndim == 3 else t
              for t in (b, c))
    flat = lambda t: t.reshape(nb * nh, *t.shape[2:])      # noqa: E731
    g = ssd_chunked_bwd_ref(flat(dta), flat(dtx), flat(b4), flat(c4),
                            flat(dy), chunk=chunk,
                            dh_final=flat(dh) if dh is not None else None)
    db, dc = (t.reshape(nb, nh, s, -1) for t in g[2:])
    if b.ndim == 3:
        db, dc = db.sum(1), dc.sum(1)
    return g[0].reshape(nb, nh, s), g[1].reshape(nb, nh, s, p), db, dc


def _close_grads(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nh,s,n,p,chunk,with_dh", [
    (1, 3, 128, 16, 32, 32, False), (2, 5, 100, 40, 48, 32, True),
    (1, 112, 23, 64, 64, 23, True), (1, 4, 300, 128, 64, 128, False),
    (2, 2, 7, 8, 8, 128, True), (1, 2, 64, 16, 16, 1, False),
    (1, 3, 4096, 64, 64, 128, True), (2, 2, 1001, 128, 64, 96, False)])
@pytest.mark.parametrize("shared", [True, False])
def test_ssd_bwd_kernel_matches_plain_version(card, nb, nh, s, n, p, chunk,
                                              with_dh, shared):
    """The backward kernels from the forward kernel's scratch against the
    plain backward; B and C per head, or [B, S, N] shared by the heads (the
    kernel sums their gradients over the heads); two calls bit-equal."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    chunk = min(chunk, s)
    dta, dtx, b4, c4 = _ssd_operands(nb, nh, s, n, p, s + n, card, shared)
    b, c = (b4[:, 0], c4[:, 0]) if shared else (b4, c4)
    rng = np.random.default_rng(s + p)
    dy = torch.from_numpy(rng.standard_normal((nb, nh, s, p)).astype(
        np.float32)).to(card)
    dh = (torch.from_numpy(rng.standard_normal((nb, nh, n, p)).astype(
        np.float32)).to(card) if with_dh else None)
    scratch = ssd_ops._scratch(dtx, n, chunk)
    _, h = ssd_ops._launch(dta, dtx, b4, c4, chunk, with_dh, scratch)
    before = ssd_ops.LAUNCHES["backward_float32"]
    got = ssd_ops._launch_bwd(dta, dtx, b, c, dy, scratch, h, dh, chunk)
    again = ssd_ops._launch_bwd(dta, dtx, b, c, dy, scratch, h, dh, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["backward_float32"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _close_grads(got, _ssd_bwd_plain(dta, dtx, b, c, dy, chunk, dh))


@pytest.mark.cuda
@pytest.mark.parametrize("nh,group,s,n,chunk,with_dh", [
    (7, 3, 300, 64, 128, True), (6, 6, 256, 128, 128, False),
    (5, 2, 200, 40, 64, True), (9, 4, 1000, 64, 128, False)])
def test_ssd_bwd_head_groups_match_plain_version(card, monkeypatch, nh, group,
                                                 s, n, chunk, with_dh):
    """The backward with its heads taken G to a block (a ragged last group
    where G does not divide the heads), B and C shared: within the plain
    backward's tolerance, two calls bit-equal.  The card's own choice
    (``ops.head_group``) gives G = 1 at these small grids."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    monkeypatch.setattr(ssd_ops, "head_group", lambda nb, nh, nc: group)
    nb, p = 1, 64
    dta, dtx, b4, c4 = _ssd_operands(nb, nh, s, n, p, s + n + nh, card)
    rng = np.random.default_rng(s + nh)
    dy = torch.from_numpy(rng.standard_normal((nb, nh, s, p)).astype(
        np.float32)).to(card)
    dh = (torch.from_numpy(rng.standard_normal((nb, nh, n, p)).astype(
        np.float32)).to(card) if with_dh else None)
    scratch = ssd_ops._scratch(dtx, n, chunk)
    _, h = ssd_ops._launch(dta, dtx, b4, c4, chunk, with_dh, scratch)
    b, c = b4[:, 0], c4[:, 0]
    got = ssd_ops._launch_bwd(dta, dtx, b, c, dy, scratch, h, dh, chunk)
    again = ssd_ops._launch_bwd(dta, dtx, b, c, dy, scratch, h, dh, chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _close_grads(got, _ssd_bwd_plain(dta, dtx, b, c, dy, chunk, dh))


# fills every block's dynamic shared memory, as much as a block may take,
# with a quiet NaN: what an earlier kernel may leave there
_POISON_CU = r"""
#include <cuda_runtime.h>

__global__ void poison_smem(int floats) {
  extern __shared__ float smem[];
  volatile float* v = smem;
  for (int i = threadIdx.x; i < floats; i += blockDim.x)
    v[i] = __int_as_float(0x7fc00000);
}

extern "C" int poison_launch(int blocks) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
  cudaFuncSetAttribute(poison_smem,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  poison_smem<<<blocks, 1024, bytes>>>(bytes / 4);
  cudaDeviceSynchronize();
  return cudaGetLastError();
}
"""


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_ssd_bwd_ignores_stale_shared_memory(card, tmp_path, shared):
    """A short last chunk whose length is no multiple of 8 (300 = 2 x 128 +
    44) after a kernel that left NaN in every SM's shared memory: the
    products run to depth round8(q) and must read zeros, not what was
    there, past the chunk's end.  Finite and within the plain backward's
    tolerance."""
    import ctypes
    import subprocess

    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import ops as ssd_ops

    src, lib = tmp_path / "poison.cu", tmp_path / "libpoison.so"
    src.write_text(_POISON_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    poison = ctypes.CDLL(str(lib)).poison_launch
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    nb, nh, s, n, p, chunk = 1, 7, 300, 64, 64, 128
    dta, dtx, b4, c4 = _ssd_operands(nb, nh, s, n, p, 17, card, shared)
    b, c = (b4[:, 0], c4[:, 0]) if shared else (b4, c4)
    rng = np.random.default_rng(18)
    dy = torch.from_numpy(rng.standard_normal((nb, nh, s, p)).astype(
        np.float32)).to(card)
    scratch = ssd_ops._scratch(dtx, n, chunk)
    _, h = ssd_ops._launch(dta, dtx, b4, c4, chunk, False, scratch)
    torch.cuda.synchronize()
    assert poison(8 * sms) == 0
    got = ssd_ops._launch_bwd(dta, dtx, b, c, dy, scratch, h, None, chunk)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close_grads(got, _ssd_bwd_plain(dta, dtx, b, c, dy, chunk, None))


@pytest.mark.cuda
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_under_autograd_runs_the_backward_kernel(card, return_state):
    """ssd() on CUDA inputs that need a gradient goes through SSDScan: one
    forward and one backward launch, gradients equal to autograd through
    the chunked plain version on the card, for B and C shared by the heads
    ([B, S, N]) as the model passes them."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    nb, nh, s, n, p, chunk = 2, 6, 300, 32, 64, 128
    dta, dtx, b4, c4 = _ssd_operands(nb, nh, s, n, p, 5, card)
    leaves = [t.detach().clone().requires_grad_()
              for t in (dta, dtx, b4[:, 0], c4[:, 0])]
    rng = np.random.default_rng(6)
    dy = torch.from_numpy(rng.standard_normal((nb, nh, s, p)).astype(
        np.float32)).to(card)
    dh = torch.from_numpy(rng.standard_normal((nb, nh, n, p)).astype(
        np.float32)).to(card)
    before = dict(ssd_ops.LAUNCHES)
    out = ssd_ops.ssd(*leaves, chunk=chunk, return_state=return_state)
    outs, cots = ((out[0], out[1]), (dy, dh)) if return_state else (
        (out,), (dy,))
    got = torch.autograd.grad(outs, leaves, cots)
    torch.cuda.synchronize()
    assert {k: ssd_ops.LAUNCHES[k] - before[k] for k in before} == {
        "float32": 1, "backward_float32": 1}

    def plain(dta, dtx, b, c):
        pad = (-s) % chunk
        flat = lambda t: torch.nn.functional.pad(             # noqa: E731
            t.reshape(nb * nh, s, -1), (0, 0, 0, pad))
        bb, cc = (t[:, None].expand(nb, nh, s, n) for t in (b, c))
        y, h = ssd_chunked_ref(
            torch.nn.functional.pad(dta.reshape(nb * nh, s), (0, pad)),
            flat(dtx), flat(bb), flat(cc), chunk=chunk, return_state=True)
        return y[:, :s].reshape(nb, nh, s, p), h.reshape(nb, nh, n, p)

    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    y_ref, h_ref = plain(*ref_leaves)
    want = torch.autograd.grad((y_ref, h_ref) if return_state else (y_ref,),
                               ref_leaves, cots)
    _close_grads(got, want)


# --------------------------------------------------------------------------- #
# flash attention: against the plain version on the card; float32 at
# rtol 2e-4 / atol 2e-5, bfloat16 at 2e-2 (outputs rounded to bf16), and
# long bf16 prompts against the float32 plain version at rtol 8e-3 /
# atol 2e-5 (the output's own bf16 rounding: P enters the tensor cores as
# two bf16 terms)
# --------------------------------------------------------------------------- #

def _bshd_views(b, h, hkv, sq, sk, d, dtype, seed, device):
    """q, k, v as [B, S, H, d] memory handed over as [B, H, S, d] views."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, s, heads, d)).astype(np.float32)).to(device, dtype).transpose(1, 2)
        for s, heads in ((sq, h), (sk, hkv), (sk, hkv)))

@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 4, 4, 100, 100, 32, True), (2, 4, 2, 130, 130, 112, True),
    (1, 8, 1, 64, 200, 64, False), (1, 4, 4, 77, 150, 128, True),
    (1, 2, 2, 150, 77, 16, True), (2, 32, 8, 256, 256, 128, True),
    (1, 3, 3, 1, 1, 8, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(card, b, h, hkv, sq, sk, d,
                                            causal, dtype):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _bshd_views(b, h, hkv, sq, sk, d, dtype, b + h + sq + sk + d,
                          card)
    name = str(dtype).split(".")[1]
    before = fa.LAUNCHES[name]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, h, sq, d)
    want = attention_ref(q.reshape(b * h, sq, d), k.reshape(b * hkv, sk, d),
                         v.reshape(b * hkv, sk, d), q_heads=h, kv_heads=hkv,
                         causal=causal).reshape(b, h, sq, d)
    tol = (dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_flash_kernel_rejections(card):
    from repro_torch.kernels.flash_attention import ops as fa

    q = torch.randn((1, 4, 64, 32), device=card)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           q, q)
    big = torch.randn((1, 2, 16, 160), device=card)
    with pytest.raises(ValueError, match="d <="):
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="reference"):
        fa.flash_attention(q, q, q, backend="reference")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [112, 64])
def test_flash_bf16_long_causal_against_float32(card, d):
    """A long causal GQA prefill in bf16 held to the float32 plain version
    on the same values at rtol 8e-3 / atol 2e-5: P rounded once to bf16
    would put outputs outside it."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _bshd_views(1, 32, 8, 2048, 2048, d, torch.bfloat16, d, card)
    before = fa.LAUNCHES["bfloat16"]
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["bfloat16"] == before + 1
    want = attention_ref(*(t.float().reshape(-1, 2048, d) for t in (q, k, v)),
                         q_heads=32, kv_heads=8).reshape(1, 32, 2048, d)
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,causal", [
    (24, 8, 64, True), (16, 16, 80, False), (64, 8, 128, True)],
    ids=["granite-moe-3b", "hubert-xlarge", "internvl2-76b"])
def test_flash_bf16_model_shapes_against_float32(card, h, hkv, d, causal):
    """The attention shapes of the moe, encoder and vlm families' long
    prefills in bf16 (d = 64 GQA, d = 80 non-causal with its 16-column
    second TMA box, d = 128 GQA 64 / 8), held to the float32 plain version
    on the same values at rtol 8e-3 / atol 2e-5."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    s = 2048
    q, k, v = _bshd_views(1, h, hkv, s, s, d, torch.bfloat16, h + d, card)
    before = fa.LAUNCHES["bfloat16"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["bfloat16"] == before + 1
    want = attention_ref(q.float().reshape(h, s, d),
                         k.float().reshape(hkv, s, d),
                         v.float().reshape(hkv, s, d), q_heads=h,
                         kv_heads=hkv, causal=causal).reshape(1, h, s, d)
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=2e-5)


@pytest.mark.cuda
def test_flash_bf16_refuses_what_tma_cannot_load(card):
    """The bf16 kernel loads q, k, v by TMA: a view one element into its
    storage (a base off 16 bytes) or d % 8 != 0 raises, and nothing
    launches."""
    from repro_torch.kernels.flash_attention import ops as fa

    base = torch.randn((1, 64, 4, 128), device=card).to(torch.bfloat16)
    good = base[..., :112].transpose(1, 2)
    shifted = base[..., 1:113].transpose(1, 2)
    cut = base[..., :100].transpose(1, 2)
    before = fa.LAUNCHES["bfloat16"]
    with pytest.raises(ValueError, match="TMA.*aligned"):
        fa.flash_attention(shifted, good, good)
    with pytest.raises(ValueError, match="TMA.*d=100"):
        fa.flash_attention(cut, cut, cut)
    assert fa.LAUNCHES["bfloat16"] == before
    fa.flash_attention(good, good, good)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["bfloat16"] == before + 1


@pytest.mark.cuda
def test_chunked_prefill_on_card_against_whole_and_cpu(card):
    """Reduced BitNet-1.58B in float32 without quantization (its int8
    activation rounding would turn float32 ulps into whole steps): a
    40-token prompt prefilled as chunks of 16 + 16 + 8 on the card against
    the whole prefill on the card and the same chunks on the CPU, logits
    and cache within 1e-4 (float32 summed in other orders), and no cache
    row past the prompt written."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device=card)
    p_cpu = cpu.init(0)
    p_gpu = params_from_jax(_numpy_tree(p_cpu), device=card)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(1, 40)))

    def chunked(api, params, device):
        cache, pos0 = api.init_cache(1, 64), 0
        for c in (16, 16, 8):
            lg, cache = api.prefill_chunk(
                params, prompt[:, pos0:pos0 + c].to(device), cache, pos0)
            pos0 += c
        return lg, cache

    lg_g, cache_g = chunked(gpu, p_gpu, card)
    lg_c, cache_c = chunked(cpu, p_cpu, "cpu")
    lg_w, cache_w = gpu.prefill(p_gpu, {"tokens": prompt.to(card)},
                                gpu.init_cache(1, 64))
    torch.cuda.synchronize()
    for got, want in ((lg_g, lg_w), (lg_g.cpu(), lg_c)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    for a, b, c in zip(cache_g, cache_w, cache_c):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        torch.testing.assert_close(a.cpu(), c, rtol=0, atol=1e-4)
        assert not a[:, :, :, 40:].any()


def routing_flips(idx_a, idx_b, probs, k, tol=1e-5):
    """Tokens whose routed experts differ between two runs, and the
    smallest margin between the k-th and (k+1)-th router probabilities
    (``probs`` from the CPU) over all tokens.  A flip is allowed only at
    such a near-tie: it raises unless that token's margin is within
    ``tol``."""
    top = torch.sort(probs, dim=-1, descending=True).values
    margin = top[..., k - 1] - top[..., k]
    flipped = (idx_a != idx_b).any(dim=-1)
    if bool((margin[flipped] > tol).any()):
        raise AssertionError(f"routing flipped at margins "
                             f"{margin[flipped].tolist()}")
    return int(flipped.sum()), float(margin.min())


@pytest.mark.cuda
def test_moe_block_on_card_against_cpu(card):
    """A reduced MoE block (float32, no quantization, experts padded to 12,
    drops at capacity factor 1.0) on the card against the CPU: the routed
    experts agree but at near-ties, and where they all agree the outputs
    agree within 1e-4 (float32 summed in other orders)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("granite-moe-3b-a800m")).replace(
        dtype="float32", quantization="none", n_experts_padded=12,
        capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    p_cpu = moe.init_moe_params(gen, cfg, torch.float32, "cpu")
    p_gpu = {name: t.to(card) for name, t in p_cpu.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    probs, _, idx_cpu = moe.route(p_cpu, cfg, x)
    _, _, idx_gpu = moe.route(p_gpu, cfg, x.to(card))
    flips, _ = routing_flips(idx_gpu.cpu(), idx_cpu, probs, cfg.top_k)
    got = moe.moe_block(p_gpu, cfg, x.to(card))
    want = moe.moe_block(p_cpu, cfg, x)
    torch.cuda.synchronize()
    _, _, keep = moe.assign_slots(idx_cpu, cfg.n_experts_total,
                                  int(cfg.top_k * 64 / cfg.n_experts + 1))
    assert not bool(keep.all())           # some tokens drop
    if flips == 0:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_dense_promotes_mixed_operands(card):
    """float32 activations by a bf16 weight give float32, as JAX's
    promotion does, on the card as on the CPU."""
    from repro_torch.models.common import dense

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32)).to(torch.bfloat16)
    got = dense(x.to(card), w.to(card))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), dense(x, w), rtol=0, atol=1e-4)
    torch.testing.assert_close(got.cpu(), x @ w.float(), rtol=0, atol=1e-4)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


# --------------------------------------------------------------------------- #
# flash backward: the kernels against the plain backward on the card, on the
# same values; float32 at the JAX custom-VJP test's rtol 2e-3 / atol 2e-4,
# bfloat16 at the JAX bf16 flash test's 2e-2 (gradients rounded to bf16);
# the forward's lse within the float32 forward tolerance
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 4, 4, 100, 100, 32, True), (2, 4, 2, 130, 130, 112, True),
    (1, 8, 1, 64, 200, 64, False), (1, 4, 4, 77, 150, 128, True),
    (1, 2, 2, 150, 77, 16, True), (1, 16, 16, 512, 512, 128, True),
    (2, 32, 8, 256, 256, 128, True), (1, 3, 3, 1, 1, 8, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_matches_plain_version(card, b, h, hkv, sq, sk,
                                                     d, causal, dtype):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_ref,
    )

    q, k, v = _bshd_views(b, h, hkv, sq, sk, d, dtype, b + h + sq + d, card)
    do = _bshd_views(b, h, h, sq, sq, d, dtype, 7 + d, card)[0]
    name = str(dtype).split(".")[1]
    before = dict(fa.LAUNCHES)
    scale = 1.0 / d ** 0.5
    o, lse = fa._launch(q, k, v, causal, scale, with_lse=True)
    grads = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
    again = fa._launch_bwd(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["lse_" + name] == before["lse_" + name] + 1
    assert fa.LAUNCHES["backward_" + name] == before["backward_" + name] + 2
    for got, other in zip(grads, again):           # no atomics: repeatable
        assert torch.equal(got, other)

    flat = lambda t: t.float().reshape(-1, t.shape[2], d)  # noqa: E731
    kw = dict(q_heads=h, kv_heads=hkv, causal=causal)
    _, lse_ref = attention_fwd_ref(flat(q), flat(k), flat(v), **kw)
    torch.testing.assert_close(lse.reshape(-1, sq), lse_ref, rtol=2e-4,
                               atol=2e-5)
    want = attention_bwd_ref(flat(q), flat(k), flat(v), flat(o), lse_ref,
                             flat(do), **kw)
    tol = (dict(rtol=2e-3, atol=2e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for got, ref, t in zip(grads, want, (q, k, v)):
        assert got.dtype == dtype and got.shape == t.shape
        torch.testing.assert_close(got.float().reshape(ref.shape), ref,
                                   **tol)


@pytest.mark.cuda
def test_flash_backward_operand_layouts(card):
    """The bf16 backward loads q, k, v and dout by TMA: a dout that TMA
    cannot read (one element into its storage) is copied and gives the
    gradients of the contiguous dout bit for bit; q, k, v or out in such
    a layout is refused."""
    from repro_torch.kernels.flash_attention import ops as fa

    q, k, v = _bshd_views(1, 4, 2, 96, 96, 64, torch.bfloat16, 3, card)
    o, lse = fa._launch(q, k, v, True, 0.125, with_lse=True)
    wide = torch.randn((1, 96, 4, 72), device=card, dtype=torch.bfloat16)
    do = wide[..., 1:65].transpose(1, 2)
    assert fa.tma_layout_error(do.shape, do.stride(), do.data_ptr())
    got = fa._launch_bwd(q, k, v, o, lse, do, True, 0.125)
    want = fa._launch_bwd(q, k, v, o, lse, do.contiguous(), True, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bad = wide[..., 1:65].transpose(1, 2)
    for i in range(4):
        args = [q, k, v, o]
        args[i] = bad if i != 1 and i != 2 else bad[:, :2]
        with pytest.raises(ValueError, match="TMA"):
            fa._launch_bwd(*args, lse, do, True, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_flows_through_the_kernels(card, dtype):
    """Under autograd the flash call records its backward: q.grad, k.grad
    and v.grad are set, through the lse forward and the backward kernel,
    equal to autograd through the plain version at the same output
    gradient (2 out, out as the kernel computed it: a bf16 output rounded
    otherwise than the float32 plain one would move the cotangent)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    base = [t.detach().requires_grad_() for t in _bshd_views(
        1, 8, 2, 300, 300, 64, dtype, 5, card)]
    name = str(dtype).split(".")[1]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*base, causal=True)
    assert out.grad_fn is not None
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["lse_" + name] == before["lse_" + name] + 1
    assert fa.LAUNCHES["backward_" + name] == before["backward_" + name] + 1
    assert fa.LAUNCHES[name] == before[name]
    ref = [t.detach().float().requires_grad_() for t in base]
    attention_ref(ref[0].reshape(8, 300, 64), ref[1].reshape(2, 300, 64),
                  ref[2].reshape(2, 300, 64), q_heads=8, kv_heads=2
                  ).backward(2 * out.detach().float().reshape(8, 300, 64))
    tol = (dict(rtol=2e-3, atol=2e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for t, r in zip(base, ref):
        assert t.grad is not None and t.grad.dtype == dtype
        torch.testing.assert_close(t.grad.float(), r.grad, **tol)


# --------------------------------------------------------------------------- #
# flash with a query offset: a context-parallel shard of the queries (query
# row i at position q_offset + i) against the whole keys, forward and
# backward, against the plain versions at the same offset; and the shards
# of a sequence joined against the whole-sequence call
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,sq,sk,d,q_offset,causal", [
    (4, 4, 64, 256, 32, 192, True), (4, 2, 100, 300, 112, 37, True),
    (8, 1, 128, 512, 64, 128, True), (2, 2, 77, 150, 128, 73, True),
    (4, 4, 64, 256, 80, 100, False), (2, 2, 50, 40, 16, 5, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_offset_kernels_match_plain_version(card, h, hkv, sq, sk, d,
                                                  q_offset, causal, dtype):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_fwd_ref,
    )

    q, k, v = _bshd_views(1, h, hkv, sq, sk, d, dtype, h + sq + q_offset,
                          card)
    do = _bshd_views(1, h, h, sq, sq, d, dtype, 11 + d, card)[0]
    scale = 1.0 / d ** 0.5
    serve = fa._launch(q, k, v, causal, scale, q_offset=q_offset)
    o, lse = fa._launch(q, k, v, causal, scale, with_lse=True,
                        q_offset=q_offset)
    grads = fa._launch_bwd(q, k, v, o, lse, do, causal, scale,
                           q_offset=q_offset)
    torch.cuda.synchronize()
    assert torch.equal(serve, o)
    flat = lambda t: t.float().reshape(-1, t.shape[2], d)  # noqa: E731
    kw = dict(q_heads=h, kv_heads=hkv, causal=causal, q_offset=q_offset)
    o_ref, lse_ref = attention_fwd_ref(flat(q), flat(k), flat(v), **kw)
    fwd_tol = (dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32
               else dict(rtol=8e-3, atol=2e-5))
    torch.testing.assert_close(flat(o), o_ref, **fwd_tol)
    torch.testing.assert_close(lse.reshape(-1, sq), lse_ref, rtol=2e-4,
                               atol=2e-5)
    want = attention_bwd_ref(flat(q), flat(k), flat(v), flat(o), lse_ref,
                             flat(do), **kw)
    tol = (dict(rtol=2e-3, atol=2e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.float().reshape(ref.shape), ref,
                                   **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shards", [(torch.float32, 4),
                                          (torch.bfloat16, 4)])
def test_flash_offset_shards_join_to_the_whole_sequence(card, dtype, shards):
    """A causal sequence of 1024 queries cut into shards of 256 at offsets
    0, 256, 512, 768: each shard's output, lse and dq equal the
    whole-sequence call's rows bit for bit (256 is a multiple of both
    kernels' query tiles, so every block computes the same rows in the
    same order), and the shards' dk and dv add up to the whole call's
    within the type's backward tolerance (each shard rounds its own sum
    to the type once)."""
    from repro_torch.kernels.flash_attention import ops as fa

    h, hkv, s, d = 4, 2, 1024, 64
    q, k, v = _bshd_views(1, h, hkv, s, s, d, dtype, 5, card)
    do = _bshd_views(1, h, h, s, s, d, dtype, 6, card)[0]
    scale = 1.0 / d ** 0.5
    o, lse = fa._launch(q, k, v, True, scale, with_lse=True)
    dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do, True, scale)
    n = s // shards
    dk_sum = torch.zeros_like(dk, dtype=torch.float32)
    dv_sum = torch.zeros_like(dv, dtype=torch.float32)
    for r in range(shards):
        rows = slice(r * n, (r + 1) * n)
        qs, dos = q[:, :, rows], do[:, :, rows]
        os_, ls = fa._launch(qs, k, v, True, scale, with_lse=True,
                             q_offset=r * n)
        assert torch.equal(os_, o[:, :, rows])
        assert torch.equal(ls, lse[:, :, rows])
        gq, gk, gv = fa._launch_bwd(qs, k, v, os_, ls, dos, True, scale,
                                    q_offset=r * n)
        assert torch.equal(gq, dq[:, :, rows])
        dk_sum += gk.float()
        dv_sum += gv.float()
    tol = (dict(rtol=2e-3, atol=2e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(dk_sum, dk.float(), **tol)
    torch.testing.assert_close(dv_sum, dv.float(), **tol)


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad(card):
    """The block-sparse and bitlinear CUDA routes have no backward: a call
    whose float inputs need a gradient raises, never falls back to the
    plain version, and the same call without a gradient runs.  (The SSD
    scan has one: test_ssd_under_autograd_runs_the_backward_kernel.)"""
    from repro_torch.kernels.block_sparse import ops as bs_ops
    from repro_torch.quant.bitnet import bit_linear_serve, pack_weight_ternary

    x, w, mask = _sparse_operands(8, 256, 128, 128, 64, 0.5, torch.float32,
                                  2, card)
    with pytest.raises(RuntimeError, match="block_sparse CUDA kernel"):
        bs_ops.ztb_matmul(x.requires_grad_(), w, mask, bk=128, bn=64)
    with torch.no_grad():
        bs_ops.ztb_matmul(x, w, mask, bk=128, bn=64)

    qw = pack_weight_ternary(torch.randn((256, 64), device=card))
    xs = torch.randn((4, 256), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="bitlinear CUDA kernel"):
        bit_linear_serve(xs, qw, backend="cuda")
    bit_linear_serve(xs.detach(), qw, backend="cuda")
    torch.cuda.synchronize()
