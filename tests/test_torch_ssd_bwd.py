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
    heads for a ``[B, S, N]`` B); its FLOP formula counts the plain
    backward's products over the causal halves of the q x q tiles (the
    plain version computes whole tiles, and recomputes each chunk's own
    state); its byte formula is ``cost.ssd_bwd_bytes``."""
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
            assert fc.get_total_flops() == cost.ssd_bwd_flops(
                nb, nh, s, n, p, chunk)
            assert ops.BYTES[torch.ops.repro_torch.ssd_scan_bwd](
                dta, dtx, b, b, dtx, scratch, None, None, work, chunk) == \
                cost.ssd_bwd_bytes(nb, nh, s, n, p, b.ndim == 3)
    bh, q = 4, 32
    args = [torch.randn(bh, 128, w) for w in (p, n, n, p)]
    with FlopCounterMode(display=False) as fc:
        ssd_chunked_bwd_ref(torch.randn(bh, 128) * 0.01, *args, chunk=q)
    tri, nc = q * (q + 1) // 2, 128 // q
    surplus = 2 * bh * nc * ((q * q - tri) * (3 * n + 2 * p) + q * n * p)
    assert cost.ssd_bwd_flops(1, bh, 128, n, p, q) == \
        fc.get_total_flops() - surplus
    # the bound: C B^T once per batch where the heads share B and C
    shared, _ = cost.ssd_bwd_bound(1, 112, 4096, 64, 64, 128, True)
    per_head, by = cost.ssd_bwd_bound(1, 112, 4096, 64, 64, 128, False)
    assert by == "operations" and shared < per_head
    assert 2 < shared / cost.ssd_bound(1, 112, 4096, 64, 64, 128, True)[0] < 3


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
