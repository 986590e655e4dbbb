"""Port parity: the SSD scan's backward (repro_torch.kernels.ssd: the plain
closed-form gradient ``ssd_chunked_bwd_ref`` and the ``SSDScan`` Function)
against ``jax.vjp`` of the JAX package's chunked and grouped scans, and the
reduced Mamba-2 and Zamba2 train steps through it against the JAX
package's, on the same seeded inputs.

Tolerances: gradients within rtol 1e-4 / atol 1e-5 * max|g| (float32
summed in another order than XLA's autodiff; the gradients of dta sum a
whole chunk's terms, so their largest elements run to a few hundred);
model train steps as ``tests/test_torch_train.py``'s: loss rel 1e-5,
gradient leaves rtol 1e-4 / atol 1e-5 * max|g|, parameters after AdamW
steps as ``_close_params`` there, its allowance counted over the model
(``_close_params`` here says why).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as tconfigs
from repro.configs import get_config, reduced
from repro.data import synthetic_batch
from repro.kernels.ssd.ref import ssd_chunked_ref as jax_chunked
from repro.kernels.ssd.ref import ssd_grouped_scan as jax_grouped
from repro.models import build_model as jax_build
from repro.train import AdamW as JaxAdamW
from repro.train import build_train_step as jax_train_step
from repro.train import init_train_state as jax_init_state
from repro_torch import train
from repro_torch.convert import train_state_from_jax
from repro_torch.kernels import cost
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
from repro_torch.models import build_model
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import value_and_grad


@pytest.fixture(autouse=True, scope="module")
def _first_exp_done():
    """A fresh process's first float32 ``torch.exp`` has been seen off by
    ~1e-4 under load (``tools/first_exp_probe.py``, ROADMAP Queue 3 note
    7): make it before the checks, as ``tests/test_torch_ssd.py`` does."""
    torch.exp(torch.linspace(-1.0, 0.0, 65536))


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _inputs(lead, s, p, n, seed, shared=False):
    """dta, dtx (scaled as the model scales them), B, C and the cotangents
    dy, dh: ``lead`` leading axes for the per-head tensors; B and C
    ``[lead[0], S, N]`` when ``shared``."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.1, size=(*lead, s)).astype(np.float32)
    a = -np.exp(rng.standard_normal(lead[-1:])).astype(np.float32)
    x = rng.standard_normal((*lead, s, p)).astype(np.float32)
    bc_lead = lead[:1] if shared else lead
    b = rng.standard_normal((*bc_lead, s, n)).astype(np.float32)
    c = rng.standard_normal((*bc_lead, s, n)).astype(np.float32)
    dy = rng.standard_normal((*lead, s, p)).astype(np.float32)
    dh = rng.standard_normal((*lead, n, p)).astype(np.float32)
    return dt * a[..., None], x * dt[..., None], b, c, dy, dh


def _jax_vjp(fn, chunk, s, axis, inputs, dy, dh):
    """``jax.vjp`` of fn (one jitted program) on inputs padded along the
    step axis to a chunk multiple (dta = 0 and zero inputs, as the JAX
    model pads), y cut back to S steps, with the cotangents (dy, dh)."""
    pad = (-s) % chunk

    def run(dta, dtx, b, c):
        def p(t, ax):
            return jnp.pad(t, [(0, pad if i == ax else 0)
                               for i in range(t.ndim)])
        y, h = fn(p(dta, axis), p(dtx, axis), p(b, b.ndim - 2),
                  p(c, c.ndim - 2), chunk=chunk, return_state=True)
        return jnp.take(y, jnp.arange(s), axis=axis), h

    def grads(dta, dtx, b, c, dy, dh):
        return jax.vjp(run, dta, dtx, b, c)[1]((dy, dh))

    return jax.jit(grads)(*(jnp.asarray(t) for t in inputs),
                          jnp.asarray(dy), jnp.asarray(dh))


# (S, P, N, chunk): whole chunks, a short last chunk, one short chunk, a
# chunk that is not a power of two
@pytest.mark.parametrize("s,p,n,chunk", [(128, 16, 8, 32), (100, 8, 16, 32),
                                         (23, 16, 8, 23), (96, 24, 40, 24),
                                         (256, 64, 32, 64)])
@pytest.mark.parametrize("with_dh", [False, True])
def test_bwd_ref_matches_jax_vjp_of_chunked_ref(s, p, n, chunk, with_dh):
    dta, dtx, b, c, dy, dh = _inputs((3,), s, p, n, s + p + n)
    want = _jax_vjp(jax_chunked, chunk, s, 1, (dta, dtx, b, c), dy,
                    dh if with_dh else np.zeros_like(dh))
    got = ssd_chunked_bwd_ref(
        *(torch.from_numpy(t) for t in (dta, dtx, b, c, dy)), chunk=chunk,
        dh_final=torch.from_numpy(dh) if with_dh else None)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w)


@pytest.mark.parametrize("bsz,h,s,p,n,chunk", [(2, 3, 128, 16, 8, 32),
                                               (1, 4, 90, 8, 16, 32)])
@pytest.mark.parametrize("with_dh", [False, True])
def test_ssd_gradient_with_shared_b_c_matches_jax_grouped_scan(
        bsz, h, s, p, n, chunk, with_dh):
    """``ops.ssd`` under autograd on the CPU (``SSDScan``, the plain
    backward) with B and C ``[B, S, N]`` shared by the heads, against
    ``jax.vjp`` of ``ssd_grouped_scan``: dB and dC come summed over the
    heads."""
    dta, dtx, b, c, dy, dh = _inputs((bsz, h), s, p, n, s + h, shared=True)
    want = _jax_vjp(jax_grouped, chunk, s, 2, (dta, dtx, b, c), dy,
                    dh if with_dh else np.zeros_like(dh))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (dta, dtx, b, c)]
    y, hfin = ops.ssd(*leaves, chunk=chunk, return_state=True)
    loss = (y * torch.from_numpy(dy)).sum()
    if with_dh:
        loss = loss + (hfin * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(loss, leaves)
    assert tuple(got[2].shape) == (bsz, s, n)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _tf32(t, nearest=True):
    """float32 to TF32 (10 mantissa bits) on the int32 view: to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds and the backward
    kernel rounds its hi parts, or toward zero, as the tensor cores read a
    float32 operand (the kernel's lo parts)."""
    i = t.view(torch.int32)
    return ((i + 0x1000 if nearest else i) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """``a @ b`` as the backward kernel takes it on the tensor cores: each
    float32 operand split as hi = tf32(x) to nearest, lo = x - hi truncated
    to TF32, the sum lo.hi + hi.lo, then hi.hi, in float32 (lo.lo
    dropped)."""
    a, b = a.contiguous(), b.contiguous()
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi, False), _tf32(b - b_hi, False)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def test_tf32_rounding_to_nearest_away_and_toward_zero():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                 -(1.0 + 2.0 ** -10), 1.0]
    assert _tf32(x, False).tolist() == [1.0, 1.0 + 2.0 ** -10, -1.0, 1.0]


@pytest.mark.parametrize("s,n,with_dh", [(512, 64, False), (512, 64, True),
                                         (640, 128, False), (600, 128, True)])
def test_bwd_ref_with_3xtf32_products_matches_jax_vjp(s, n, with_dh):
    """The plain backward with every product in 3xTF32 (the backward
    kernel's tensor-core arithmetic) against ``jax.vjp`` of the chunked
    scan at the kernel's tolerance, chunk 128, P = 64: the split keeps
    float32's accuracy where one TF32 product would not."""
    p, chunk = 64, 128
    dta, dtx, b, c, dy, dh = _inputs((3,), s, p, n, s + n + 7)
    want = _jax_vjp(jax_chunked, chunk, s, 1, (dta, dtx, b, c), dy,
                    dh if with_dh else np.zeros_like(dh))
    got = ssd_chunked_bwd_ref(
        *(torch.from_numpy(t) for t in (dta, dtx, b, c, dy)), chunk=chunk,
        dh_final=torch.from_numpy(dh) if with_dh else None,
        matmul=_mm_3xtf32)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def _group_bwd(dta, dtx, b, c, dy, chunk, dh_final, group, mm):
    """The backward kernel's own arithmetic (``csrc/ssd_bwd.cu``) in plain
    tensor operations, for B and C ``[B, S, N]`` shared by the heads:
    C B^T once, per head M1 = (dy x^T) o L, its sum over a group of
    ``group`` heads taken in head order, the group's dC and dB as
    (sum M1) B and (sum M1)^T C after the heads' state terms, the groups'
    partials summed in order; dla from the row and column sums of
    M1 o (C B^T) and the state terms' row dots.  Products through ``mm``."""
    nb, nh, s, p = dtx.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    f = lambda t: F.pad(t, (0, 0, 0, pad))              # noqa: E731
    dta, dtx, dy, b, c = F.pad(dta, (0, pad)), f(dtx), f(dy), f(b), f(c)
    nc, q = (s + pad) // chunk, chunk
    mT = lambda t: t.transpose(-1, -2)                  # noqa: E731
    la = torch.cumsum(dta.reshape(nb, nh, nc, q), -1)
    a_tot = la[..., -1]
    x, gy = dtx.reshape(nb, nh, nc, q, p), dy.reshape(nb, nh, nc, q, p)
    bc, cc = b.reshape(nb, 1, nc, q, n), c.reshape(nb, 1, nc, q, n)
    idx = torch.arange(q)
    lower = idx[:, None] >= idx[None, :]
    L = torch.where(lower, torch.exp(torch.where(
        lower, la[..., :, None] - la[..., None, :], 0.0)), 0.0)
    ev, fv = torch.exp(la)[..., None], torch.exp(a_tot[..., None] - la)[
        ..., None]
    # entering states and state gradients, as the kernels 1 and 2 and the
    # forward leave them
    own = mm(mT(bc * fv), x)
    u = mm(mT(cc * ev), gy)
    h = torch.zeros(nb, nh, n, p)
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = torch.exp(a_tot[..., k])[..., None, None] * h + own[:, :, k]
    h_in = torch.stack(h_in, 2)
    h_out = torch.cat([h_in[:, :, 1:], h[:, :, None]], 2)
    g = torch.zeros(nb, nh, n, p) if dh_final is None else dh_final
    g_out = [None] * nc
    for k in reversed(range(nc)):
        g_out[k] = g
        g = torch.exp(a_tot[..., k])[..., None, None] * g + u[:, :, k]
    g_out = torch.stack(g_out, 2)

    cb = mm(cc, mT(bc))                                 # once per batch
    m1 = mm(gy, mT(x)) * L
    t = m1 * cb
    bg = mm(bc, g_out)
    dla = (t.sum(-1) - t.sum(-2)
           + ev[..., 0] * (gy * mm(cc, h_in)).sum(-1)
           - fv[..., 0] * (x * bg).sum(-1))
    dla[..., -1] += (g_out * h_out).sum((-2, -1))
    ddta = torch.flip(torch.cumsum(torch.flip(dla, (-1,)), -1), (-1,))
    ddtx = fv * bg + mm(mT(cb * L), gy)

    dc_parts, db_parts = [], []
    for h0 in range(0, nh, group):
        dcp = dbp = msum = 0
        for hh in range(h0, min(h0 + group, nh)):
            dcp = dcp + mm(ev[:, hh] * gy[:, hh], mT(h_in[:, hh]))
            dbp = dbp + mm(fv[:, hh] * x[:, hh], mT(g_out[:, hh]))
            msum = msum + m1[:, hh]
        dc_parts.append(dcp + mm(msum, bc[:, 0]))
        db_parts.append(dbp + mm(mT(msum), cc[:, 0]))
    dc, db = dc_parts[0], db_parts[0]
    for dcp, dbp in zip(dc_parts[1:], db_parts[1:]):
        dc, db = dc + dcp, db + dbp

    def back(t, *tail):
        return t.reshape(*t.shape[:-2 - len(tail)], nc * q, *tail)[
            ..., :s, :] if tail else t.reshape(nb, nh, nc * q)[..., :s]

    return (back(ddta), back(ddtx, p), db.reshape(nb, nc * q, n)[:, :s],
            dc.reshape(nb, nc * q, n)[:, :s])


@pytest.mark.parametrize("h,group,s,n,with_dh", [
    (6, 3, 512, 64, False), (7, 3, 600, 64, True), (5, 2, 512, 128, True),
    (4, 4, 300, 128, False)])
def test_head_group_partial_sums_match_jax_grouped_scan(h, group, s, n,
                                                        with_dh):
    """The backward kernel's arithmetic with its head groups (a ragged
    last group where ``group`` does not divide the heads), 3xTF32
    products, against ``jax.vjp`` of the grouped scan at the kernel's
    tolerance, chunk 128, P = 64, B and C shared by the heads."""
    p, chunk = 64, 128
    dta, dtx, b, c, dy, dh = _inputs((1, h), s, p, n, s + h + n,
                                     shared=True)
    want = _jax_vjp(jax_grouped, chunk, s, 2, (dta, dtx, b, c), dy,
                    dh if with_dh else np.zeros_like(dh))
    got = _group_bwd(*(torch.from_numpy(t) for t in (dta, dtx, b, c, dy)),
                     chunk, torch.from_numpy(dh) if with_dh else None,
                     group, _mm_3xtf32)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w)


@pytest.fixture
def count_plain_backward(monkeypatch):
    """Calls of SSDScan's CPU backward (the plain closed form)."""
    calls = []
    real = ops.ssd_chunked_bwd_ref

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "ssd_chunked_bwd_ref", counted)
    return calls


@pytest.mark.parametrize("shared", [False, True])
def test_ssd_scan_function_matches_autograd_of_plain_version(
        shared, count_plain_backward):
    """SSDScan on the CPU against torch autograd through
    ``ssd_chunked_ref`` (padded to a chunk multiple) on the same values,
    with and without the terminal state; one plain backward a call, and
    no launch counted."""
    nb, nh, s, p, n, chunk = 2, 3, 70, 8, 6, 16
    arrays = _inputs((nb, nh), s, p, n, 4, shared=shared)
    dy, dh = (torch.from_numpy(t) for t in arrays[4:])
    leaves = [torch.from_numpy(t).requires_grad_() for t in arrays[:4]]

    def plain(dta, dtx, b, c):
        if shared:
            b, c = (t[:, None].expand(nb, nh, s, n) for t in (b, c))
        flat = [t.reshape(nb * nh, s, -1) for t in (dtx, b, c)]
        pad = (-s) % chunk
        d = F.pad(dta.reshape(nb * nh, s), (0, pad))
        x, bb, cc = (F.pad(t, (0, 0, 0, pad)) for t in flat)
        y, h = ssd_chunked_ref(d, x, bb, cc, chunk=chunk, return_state=True)
        return y[:, :s].reshape(nb, nh, s, p), h.reshape(nb, nh, n, p)

    for with_state in (False, True):
        out = ops.ssd(*leaves, chunk=chunk, return_state=with_state)
        y, h = out if with_state else (out, None)
        y_ref, h_ref = plain(*leaves)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
        loss = (y * dy).sum() + ((h * dh).sum() if with_state else 0)
        loss_ref = (y_ref * dy).sum() + ((h_ref * dh).sum() if with_state
                                         else 0)
        got = torch.autograd.grad(loss, leaves)
        want = torch.autograd.grad(loss_ref, leaves)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g.numpy(), w.numpy())
    assert count_plain_backward == [chunk, chunk]
    assert ops.LAUNCHES == {"float32": 0, "backward_float32": 0}


def test_bwd_custom_op_fake_outputs_flops_and_bytes():
    """The backward's custom op traces on fake tensors: ddta and ddtx in
    [B, S, H, ...] memory order, dB and dC in B's shape (summed over the
    heads for a ``[B, S, N]`` B); its FLOP formula counts the kernels'
    products, C B^T and the group's dB and dC products once per head group
    where the heads share B and C (``ops.head_group``); per head each has
    the plain backward's products over the causal halves of the q x q
    tiles (the plain version computes whole tiles, and recomputes each
    chunk's own state where the kernel computes C H_in, as many
    operations); its byte formula is ``cost.ssd_bwd_bytes``."""
    nb, nh, s, p, n, chunk = 2, 3, 40, 16, 8, 16
    with FakeTensorMode():
        dtx = torch.empty(nb, nh, s, p)
        dta = torch.empty(nb, nh, s)
        scratch = torch.empty(sum(ops.scratch_sizes(nb, nh, s, n, p, chunk)))
        for b in (torch.empty(nb, s, n), torch.empty(nb, nh, s, n)):
            work = torch.empty(sum(ops.bwd_work_sizes(
                nb, nh, s, n, p, chunk, b.ndim == 3)))
            with FlopCounterMode(display=False) as fc:
                ddta, ddtx, db, dc = torch.ops.repro_torch.ssd_scan_bwd(
                    dta, dtx, b, b, dtx, scratch, None, None, work, chunk)
            assert ddta.shape == dta.shape and ddtx.shape == dtx.shape
            assert ddtx.stride() == torch.empty(nb, s, nh, p).transpose(
                1, 2).stride()
            assert db.shape == b.shape and dc.shape == b.shape
            group = ops.head_group(nb, nh, -(-s // chunk)) \
                if b.ndim == 3 else 1
            assert fc.get_total_flops() == cost.ssd_bwd_flops(
                nb, nh, s, n, p, chunk, group)
            assert ops.BYTES[torch.ops.repro_torch.ssd_scan_bwd](
                dta, dtx, b, b, dtx, scratch, None, None, work, chunk) == \
                cost.ssd_bwd_bytes(nb, nh, s, n, p, b.ndim == 3)
    bh, q = 4, 32
    args = [torch.randn(bh, 128, w) for w in (p, n, n, p)]
    with FlopCounterMode(display=False) as fc:
        ssd_chunked_bwd_ref(torch.randn(bh, 128) * 0.01, *args, chunk=q)
    tri, nc = q * (q + 1) // 2, 128 // q
    surplus = 2 * bh * nc * (q * q - tri) * (3 * n + 2 * p)
    assert cost.ssd_bwd_flops(1, bh, 128, n, p, q) == \
        fc.get_total_flops() - surplus
    # a head group of G takes C B^T and its dB and dC products once
    assert cost.ssd_bwd_flops(1, 8, 128, n, p, q, 4) == \
        cost.ssd_bwd_flops(1, 8, 128, n, p, q) - 2 * 6 * nc * 3 * tri * n
    # the bound: C B^T and the dB and dC products once per batch where the
    # heads share B and C, on the tensor cores as 3xTF32 and on the float32
    # CUDA cores
    f32 = cost.F32_OPS_PER_S
    shared, _ = cost.ssd_bwd_bound(1, 112, 4096, 64, 64, 128, True,
                                   op_rate=f32)
    per_head, by = cost.ssd_bwd_bound(1, 112, 4096, 64, 64, 128, False,
                                      op_rate=f32)
    assert by == "operations" and shared < per_head
    assert 2 < shared / cost.ssd_bound(1, 112, 4096, 64, 64, 128, True)[0] < 3
    tensor, by = cost.ssd_bwd_bound(1, 112, 4096, 64, 64, 128, True)
    assert by == "operations"
    assert tensor == pytest.approx(shared * f32 / cost.TF32X3_OPS_PER_S)


@pytest.mark.parametrize("nb,nh,nc,want", [
    (1, 112, 32, 28), (1, 24, 32, 6), (1, 112, 8, 7), (1, 7, 3, 1)])
def test_head_group_fills_one_wave_of_an_h100(monkeypatch, nb, nh, nc, want):
    """The wave model's G on an H100's 132 SMs: at Zamba2-7B's and
    Mamba2-130m's training shapes and a 1000-token Zamba2 prompt, the G
    whose grid is one wave (the fastest measured there); G = 1 where even
    G = 1 leaves SMs idle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ops.head_group(nb, nh, nc) == want
    blocks = -(-nh // want) * nc * nb
    assert blocks <= ops.SMS


@pytest.mark.parametrize("nb,nh,s,n,p,chunk", [
    (1, 112, 4096, 64, 64, 128), (1, 24, 4096, 128, 64, 128),
    (1, 112, 1000, 64, 64, 128), (2, 7, 300, 16, 8, 32)])
def test_ssd_bwd_bound_counts_no_more_than_the_kernels_issue(nb, nh, s, n,
                                                             p, chunk):
    """The bound's operations never exceed what the kernels issue, at any
    head group: with shared B and C at every G <= H, per head at G = 1."""
    shared = cost.ssd_bwd_ops(nb, nh, s, n, p, chunk, True)
    for group in range(1, nh + 1):
        assert shared <= cost.ssd_bwd_flops(nb, nh, s, n, p, chunk, group)
    assert cost.ssd_bwd_ops(nb, nh, s, n, p, chunk, False) <= \
        cost.ssd_bwd_flops(nb, nh, s, n, p, chunk)


# --------------------------------------------------------------------------- #
# reduced Mamba-2 and Zamba2 train steps through the plain backward
# --------------------------------------------------------------------------- #

SEQ = 100     # three whole chunks of 32 and a short one


@functools.lru_cache(maxsize=None)
def _models(arch):
    """The JAX and port models of reduced ``arch`` (float32, no
    quantization) and the JAX gradient and train step, compiled once for
    every test of this file."""
    kw = dict(dtype="float32", quantization="none")
    jcfg = reduced(get_config(arch)).replace(**kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(**kw)
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jopt = JaxAdamW(lr=1e-3)
    return (jcfg, tcfg, japi, tapi, jopt,
            jax.jit(jax.value_and_grad(japi.loss)),
            jax.jit(jax_train_step(japi, jopt)))


def _batch(cfg, step):
    np_batch = synthetic_batch(cfg, batch=2, seq=SEQ, step=step)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _close_trees(port_tree, jax_tree):
    got, want = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a.detach().float().numpy(), b)


def _close_params(port_state, jax_state, lr):
    """As ``tests/test_torch_train.py::_close_params`` (every element within
    one step's move, lr, per step; elsewhere rtol 1e-4 / atol 1e-5 *
    max|p| of its leaf), with its allowance of 1 in 10^4 elements outside
    rtol 1e-4 counted over the whole model rather than leaf by leaf.  Where
    a gradient element is near zero AdamW's normalised step
    lr * mu / (sqrt(nu) + eps) is ill-conditioned, and the SSM blocks'
    convolution bias, zero at the start, is nothing but such steps: after
    3 steps its 1,152 elements at reduced Zamba2 hold a few outside rtol
    1e-4, as many with autograd through the plain scan as with the closed
    form backward, where a per-leaf allowance is 1."""
    steps = int(jax_state.opt.step)
    loose = total = 0
    for a, b in zip(tree_leaves(port_state.params),
                    jax.tree.leaves(jax_state.params)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=lr * steps)
        loose += int((~np.isclose(a, b, rtol=1e-4,
                                  atol=1e-5 * float(np.abs(b).max()))).sum())
        total += b.size
    assert loose <= max(1, total // 10 ** 4), (
        f"{loose} of {total} outside rtol 1e-4")


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_train_steps_against_jax(arch, steps, count_plain_backward):
    """Reduced Mamba-2 and Zamba2 (float32, no quantization, 2 x 100
    tokens: a short last chunk) from the same state: the loss and every
    gradient leaf against JAX's ``value_and_grad`` (JAX differentiates its
    grouped scan), then ``steps`` AdamW steps against JAX's train step.
    Every SSM layer's scan takes the port's plain backward once a
    backward pass."""
    jcfg, tcfg, japi, tapi, jopt, jvg, jstep = _models(arch)
    jst = jax_init_state(japi, jopt, jax.random.PRNGKey(0))
    tst = train_state_from_jax(jax.tree.map(np.asarray, jst), device="cpu")
    jb, tb = _batch(jcfg, 0)
    jl, jg = jvg(jst.params, jb)
    tl, tg = value_and_grad(tapi.loss, tst.params, tb)
    assert count_plain_backward == [tcfg.ssd_chunk] * tcfg.layers
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _close_trees(tg, jg)

    tstep = train.build_train_step(tapi, train.AdamW(lr=1e-3))
    for i in range(steps):
        jb, tb = _batch(jcfg, i)
        jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    assert len(count_plain_backward) == tcfg.layers * (steps + 1)
    _close_params(tst, jst, 1e-3)
    _close_trees((tst.opt.mu, tst.opt.nu), (jst.opt.mu, jst.opt.nu))
