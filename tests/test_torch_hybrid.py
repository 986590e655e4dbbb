"""Port parity: the Mamba-2 (``ssm``) and Zamba2-style ``hybrid`` families
of repro_torch.models against repro.models on reduced configs, the same
parameters through params_from_jax.

Tolerance: atol = rtol = 1e-5 with BitNet quantization, compared per layer
before quantization (the ``lockstep`` technique of test_torch_models.py:
float32 on both sides, summed in other orders, agrees to a few ulps, which
can move an int8 rounding by a whole step); 1e-4 for whole-model float32
runs without quantization, where the SSD state carries the ulps through
every step of a long prompt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
import repro.models.hybrid as jax_hybrid
import repro_torch.configs as tconfigs
import repro_torch.models.attention as port_attention
import repro_torch.models.hybrid as port_hybrid
import repro_torch.models.mamba2 as port_mamba2
from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro.serve import ServeEngine as JaxEngine
from repro.serve.engine import prepare_params as jax_prepare
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import prepare_params
from test_torch_models import lockstep

TOL = dict(rtol=1e-5, atol=1e-5)
WHOLE = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["mamba2-130m", "zamba2-7b"]


def _pair(arch, **kw):
    jcfg = reduced(get_config(arch)).replace(dtype="float32", **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(
        dtype="float32", **{k: v for k, v in kw.items()
                            if k != "kernel_backend"})
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, japi, jp, tapi, tp


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        1, 512, size=(b, s)).astype(np.int32)


def _close(port_tree, jax_tree, tol):
    for t, j in zip(port_tree, jax_tree):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.fixture(scope="module", params=[
    (arch, kb) for arch in ARCHS for kb in ("reference", "pallas")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    """Quantized reduced models; the JAX side at both kernel backends (its
    Pallas branch runs the SSD kernel in interpret mode when no state is
    asked for, else the chunked reference)."""
    arch, kb = request.param
    return _pair(arch, kernel_backend=kb)


def test_prefill_logits_and_cache(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(2, 45)               # not a multiple of the 32-step chunk
    with lockstep(monkeypatch) as run:
        (jl, jc), (tl, tc) = run(
            lambda: japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                                 japi.init_cache(2, 64)),
            lambda: tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tapi.init_cache(2, 64)))
    assert tuple(tl.shape) == (2, 1, jcfg.vocab)
    assert len(tc) == len(jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close(tc, jc, TOL)


def test_decode_steps_per_slot_positions(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(2, 12, seed=1)
    pos = np.array([12, 12], np.int32)
    tok = np.array([7, 11], np.int32)
    with lockstep(monkeypatch) as run:
        (_, jc), (_, tc) = run(
            lambda: japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                                 japi.init_cache(2, 16)),
            lambda: tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tapi.init_cache(2, 16)))
        for _ in range(2):
            (jl, jc), (tl, tc) = run(
                lambda: japi.decode(jp, jnp.asarray(tok), jc,
                                    jnp.asarray(pos)),
                lambda: tapi.decode(tp, torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos)))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            _close(tc, jc, TOL)
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
            pos = pos + 1


def test_train_shaped_forward(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(2, 64, seed=2)
    with lockstep(monkeypatch) as run:
        jl, tl = run(
            lambda: japi.train_logits(jp, {"tokens": jnp.asarray(toks)}),
            lambda: tapi.train_logits(tp, {"tokens": torch.from_numpy(toks)}))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("layers,every", [(81, 6), (4, 2), (5, 2), (12, 6),
                                          (7, 7)])
def test_layer_order_matches_periods(layers, every, monkeypatch):
    """The port's loop (shared block before layer i when i % every == 0)
    visits blocks in the JAX package's period/tail order."""
    cfg = tconfigs.reduced(tconfigs.get_config("zamba2-7b")).replace(
        layers=layers, attn_every=every)
    jcfg = reduced(get_config("zamba2-7b")).replace(layers=layers,
                                                    attn_every=every)
    p, tail = jax_hybrid._periods(jcfg)
    want = []
    for period in range(p):
        want += ["attn"] + list(range(period * every, (period + 1) * every))
    want += ["attn"] + list(range(p * every, p * every + tail))
    seen = []
    monkeypatch.setattr(port_hybrid, "_shared_block",
                        lambda cfg, shared, x, *a, **k: (seen.append("attn"),
                                                         (x, None))[1])
    monkeypatch.setattr(port_mamba2, "run_blocks",
                        lambda cfg, blocks, x, ls, **k: (seen.extend(ls),
                                                         x)[1])
    port_hybrid._forward_cached(cfg, {"shared": None, "blocks": None},
                                torch.zeros(1, 1, 4), None)
    assert seen == want
    assert seen.count("attn") == port_hybrid.n_attn_apps(cfg)


def test_flash_path_prefill_matches_jax(monkeypatch):
    """A 3072-token prompt: the JAX hybrid's attention takes its chunked
    flash twin (_flash_ref), the port's the flash wrapper (plain version on
    the CPU)."""
    jcfg, japi, jp, tapi, tp = _pair("zamba2-7b", quantization="none")
    calls = {"jax": 0, "port": 0}
    jax_flash = jax_attention._flash_ref
    port_flash = port_attention.flash_attention

    def count(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jax_attention, "_flash_ref", count("jax", jax_flash))
    monkeypatch.setattr(port_attention, "flash_attention",
                        count("port", port_flash))
    toks = _tokens(1, 3072, seed=3)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                          japi.init_cache(1, 3080))
    tl, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          tapi.init_cache(1, 3080))
    apps = port_hybrid.n_attn_apps(tapi.cfg)
    # JAX counts traces (its period scan and its tail), the port calls
    assert calls["jax"] > 0 and calls["port"] == apps
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **WHOLE)
    _close(tc, jc, WHOLE)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(
        dtype="float32", quantization="none")
    api = build_model(cfg, device="cpu")
    params = api.init(1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 33)))
    full = api.train_logits(params, {"tokens": toks})
    lg, cache = api.prefill(params, {"tokens": toks[:, :32]},
                            api.init_cache(2, 40))
    torch.testing.assert_close(lg[:, 0], full[:, 31], rtol=2e-4, atol=2e-4)
    lg2, cache = api.decode(params, toks[:, 32], cache, 32)
    torch.testing.assert_close(lg2[:, 0], full[:, 32], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_continuous_batching(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    api = build_model(cfg, device="cpu")
    params = prepare_params(api.init(0))
    eng = ServeEngine(api, params, max_slots=3, max_seq=96)
    for i in range(5):
        eng.submit(np.arange(1, 4 + i), max_new_tokens=4 + i % 3)
    done = eng.run_until_done()
    assert len(done) == 5
    for r in done:
        assert len(r.output) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in r.output)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_matches_jax_engine(arch):
    jcfg, japi, jp, tapi, tp = _pair(arch, quantization="none")
    outs = []
    for engine, api, params in ((JaxEngine, japi, jp),
                                (ServeEngine, tapi, tp)):
        eng = engine(api, params, max_slots=2, max_seq=64)
        rng = np.random.default_rng(0)
        for _ in range(4):
            eng.submit(rng.integers(1, 512, size=rng.integers(4, 12)),
                       max_new_tokens=5)
        outs.append([(r.uid, r.output) for r in eng.run_until_done()])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_params_quantizes_ssm_and_shared_projections(arch):
    _, _, jp, _, tp = _pair(arch)
    jq, tq = jax_prepare(jp), prepare_params(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jq)[0]
    for path, leaf in flat_j:
        node = tq
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   rtol=1e-6, atol=1e-7)
    for name in ("in_proj_z", "in_proj_xbc", "in_proj_dt", "out_proj"):
        w = tq["blocks"]["ssm"][name][0]
        assert len(torch.unique(w)) <= 3, name   # ternary x one scale


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_needs_a_card_or_a_device(arch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tconfigs.get_config(arch))
