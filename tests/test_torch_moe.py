"""Port parity: repro_torch.models.moe and the MoE transformer family
against repro.models on reduced granite-moe-3b-a800m in float32, the same
parameters through params_from_jax.

Routing (expert indices, keep masks, slot positions) must be equal: the
dispatch buffer the JAX block hands to its sharding constraint is held
exactly against the one the port's routing implies.  Outputs and logits
agree within atol = rtol = 1e-5, compared per layer before quantization
with ``lockstep`` (test_torch_models.py), as for the dense family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
import repro_torch.configs as tconfigs
import repro_torch.models.moe as port_moe
from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from test_torch_models import lockstep

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "granite-moe-3b-a800m"


def _cfgs(**kw):
    """Reduced configs (8 real experts, top-2) padded to 12 experts, so
    that dummy experts are present."""
    kw = dict(dtype="float32", n_experts_padded=12, **kw)
    return (reduced(get_config(ARCH)).replace(**kw),
            tconfigs.reduced(tconfigs.get_config(ARCH)).replace(**kw))


def _block_params(jcfg, seed=0):
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _jax_top_k(jp, jcfg, x):
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


@pytest.mark.parametrize("capacity_factor", [8.0, 0.1],
                         ids=["no-drops", "drops"])
@pytest.mark.parametrize("quantization", ["none", "bitnet"])
def test_moe_block_routing_and_output(quantization, capacity_factor,
                                      monkeypatch):
    jcfg, tcfg = _cfgs(quantization=quantization,
                       capacity_factor=capacity_factor)
    assert jcfg.n_experts_total > jcfg.n_experts
    jp, tp = _block_params(jcfg)
    b, s, d = 2, 16, jcfg.d_model
    x = _x(b, s, d)

    # the JAX dispatch buffer, as the block hands it to its constraint
    bufs = []

    def record(a, *axes):
        bufs.append(np.asarray(a))
        return a
    monkeypatch.setattr(jax_moe, "constrain", record)
    jax_fn = lambda: jax_moe.moe_block(jp, jcfg, jnp.asarray(x))  # noqa: E731
    port_fn = lambda: port_moe.moe_block(tp, tcfg,                 # noqa: E731
                                         torch.from_numpy(x))
    if quantization == "bitnet":
        with lockstep(monkeypatch) as run:
            jy, ty = run(jax_fn, port_fn)
    else:
        jy, ty = jax_fn(), port_fn()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)

    # routed indices equal jax.lax.top_k's
    _, _, idx = port_moe.route(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), _jax_top_k(jp, jcfg, x))

    # keep masks and slot positions: the buffer they imply is JAX's
    cap = int(capacity_factor * jcfg.top_k * s / jcfg.n_experts + 1)
    e_flat, slot_pos, keep = port_moe.assign_slots(
        idx, tcfg.n_experts_total, cap)
    want = np.zeros((b, jcfg.n_experts_total, cap, d), np.float32)
    for bi, j in zip(*np.nonzero(keep.numpy())):
        want[bi, e_flat[bi, j], slot_pos[bi, j]] = x[bi, j // jcfg.top_k]
    np.testing.assert_array_equal(bufs[0], want)
    dropped = ~keep.numpy()
    if capacity_factor < 1:
        # a dropped token parks on slot cap - 1 of an expert whose last
        # slot a kept token holds: an assigning scatter would zero it
        kept_last = {(bi, int(e_flat[bi, j])) for bi, j in
                     zip(*np.nonzero(keep.numpy() & (slot_pos.numpy()
                                                     == cap - 1)))}
        assert any((bi, int(e_flat[bi, j])) in kept_last
                   for bi, j in zip(*np.nonzero(dropped)))
    else:
        assert not dropped.any()


def test_ties_go_to_the_lower_expert_index():
    """Exactly tied router probabilities: the port picks what
    jax.lax.top_k picks, the lower expert index first."""
    jcfg, tcfg = _cfgs(quantization="none")
    jp, tp = _block_params(jcfg)
    d, e = jcfg.d_model, jcfg.n_experts
    rng = np.random.default_rng(3)
    # small integers: every logit is exact, so equal columns tie exactly
    router = rng.integers(-2, 3, size=(d, e)).astype(np.float32)
    router[:, [2, 5, 6]] = router[:, [0]] + 2.0
    x = rng.integers(0, 3, size=(1, 12, d)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    _, _, idx = port_moe.route(tp, tcfg, torch.from_numpy(x))
    want = _jax_top_k(jp, jcfg, x)
    np.testing.assert_array_equal(idx.numpy(), want)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    assert bool((probs[..., 2] == probs[..., 5]).all())
    assert (want[..., 0] == 2).any() and (want[..., 1] == 5).any()
    np.testing.assert_allclose(
        port_moe.moe_block(tp, tcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jax_moe.moe_block(jp, jcfg, jnp.asarray(x))), **TOL)


def test_load_balance_loss():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=2)
    x = _x(2, 24, jcfg.d_model, seed=4)
    got = port_moe.load_balance_loss(tp, tcfg, torch.from_numpy(x))
    want = jax_moe.load_balance_loss(jp, jcfg, jnp.asarray(x))
    assert got.ndim == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------- #
# The whole reduced model
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, japi, jp, tapi, tp


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        1, 512, size=(b, s)).astype(np.int32)


def _close(port_tree, jax_tree):
    for t, j in zip(port_tree, jax_tree):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_model_train_logits_and_loss(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(2, 12, seed=2)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    with lockstep(monkeypatch) as run:
        jl, tl = run(
            lambda: japi.train_logits(jp, {"tokens": jnp.asarray(toks)}),
            lambda: tapi.train_logits(tp, {"tokens": torch.from_numpy(toks)}))
        jloss, tloss = run(
            lambda: japi.loss(jp, {k: jnp.asarray(v)
                                   for k, v in batch.items()}),
            lambda: tapi.loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)


def test_model_prefill_and_decode(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(2, 12, seed=1)
    pos = np.array([12, 12], np.int32)
    with lockstep(monkeypatch) as run:
        (jl, jc), (tl, tc) = run(
            lambda: japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                                 japi.init_cache(2, 16)),
            lambda: tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tapi.init_cache(2, 16)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close(tc, jc)
        for _ in range(2):
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
            (jl, jc), (tl, tc) = run(
                lambda: japi.decode(jp, jnp.asarray(tok), jc,
                                    jnp.asarray(pos)),
                lambda: tapi.decode(tp, torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos)))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            _close(tc, jc)
            pos = pos + 1


def test_model_chunked_prefill_against_jax_chunks(models, monkeypatch):
    """Chunked MoE prefill is held against the JAX package's chunked
    prefill, not its whole prefill: the capacity follows the chunk length,
    so the two differ wherever a token drops (ROADMAP.md, Queue 3)."""
    jcfg, japi, jp, tapi, tp = models
    prompt = _tokens(2, 12, seed=5)
    jc, tc, pos0 = japi.init_cache(2, 16), tapi.init_cache(2, 16), 0
    with lockstep(monkeypatch) as run:
        for c in (4, 4, 4):
            chunk = prompt[:, pos0:pos0 + c]
            (jl, jc), (tl, tc) = run(
                lambda: japi.prefill_chunk(jp, jnp.asarray(chunk), jc, pos0),
                lambda: tapi.prefill_chunk(tp, torch.from_numpy(chunk), tc,
                                           pos0))
            pos0 += c
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close(tc, jc)


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_chunked_moe_prefill_differs_from_whole_where_tokens_drop(
        capacity_factor):
    """A property of the reference that the port keeps: capacity follows
    the call's length, so a 48-token prompt prefilled as 16 + 16 + 16
    routes like the whole prompt only when no token drops (capacity factor
    8); at the configs' 1.25 the last logits differ by ~0.32 (float32, no
    quantization)."""
    _, tcfg = _cfgs(quantization="none", capacity_factor=capacity_factor)
    api = build_model(tcfg, device="cpu")
    params = api.init(0)
    prompt = torch.from_numpy(_tokens(1, 48, seed=5))
    whole, _ = api.prefill(params, {"tokens": prompt}, api.init_cache(1, 64))
    cache = api.init_cache(1, 64)
    for pos0 in (0, 16, 32):
        chunked, cache = api.prefill_chunk(params, prompt[:, pos0:pos0 + 16],
                                           cache, pos0)
    gap = float((chunked - whole).abs().max())
    if capacity_factor > 1.25:
        assert gap <= 1e-5
    else:
        assert gap > 1e-2
