"""Port parity: repro_torch.models against repro.models on reduced
BitNet-1.58B in float32, the same parameters through params_from_jax.

Tolerance: atol = rtol = 1e-5.  Both sides compute in float32, but XLA and
ATen sum the matmuls and reductions in different orders, so results agree
to a few float32 ulps of the values involved (observed ~1e-6), not bit for
bit.  A few ulps can move an activation across a rounding boundary of the
int8 fake-quant, which then differs by a whole quantization step.  So the
model tests compare per layer *before* quantization: the JAX forward runs
eagerly and records every activation-quantizer input and output; the port's
quantizer checks its input against the recorded one (within the tolerance)
and continues from the JAX package's quantized output.  The quantizers
themselves are held bit-exact on identical inputs.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro.models.common as jax_common
import repro.models.moe as jax_moe
import repro_torch.models.common as port_common
import repro_torch.models.moe as port_moe
from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro.quant import bitnet as jax_bitnet
from repro_torch.quant import bitnet as port_bitnet
from repro.serve.engine import prepare_params as jax_prepare
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve.engine import prepare_params

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=["init", "served"])
def models(request):
    jcfg = reduced(get_config("bitnet-1.58b")).replace(dtype="float32")
    tcfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32")
    japi = jax_build(jcfg)
    tapi = build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    if request.param == "served":          # offline ternary quantization
        jp, tp = jax_prepare(jp), prepare_params(tp)
        for a, b in zip(jax.tree.leaves(jp["blocks"]["attn"]),
                        [tp["blocks"]["attn"][k]
                         for k in sorted(tp["blocks"]["attn"])]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    return jcfg, japi, jp, tapi, tp


@contextlib.contextmanager
def lockstep(monkeypatch):
    """Run a JAX call, then the port's call, quantizer by quantizer (the
    MoE modules import ``fake_quant_act`` by name, so they are patched
    too)."""
    tape = []

    def jax_fq(x):
        out = jax_bitnet.fake_quant_act(x)
        tape.append((np.asarray(x), np.asarray(out)))
        return out

    def port_fq(x):
        want_in, want_out = tape.pop(0)
        np.testing.assert_allclose(x.numpy(), want_in, **TOL)
        return torch.from_numpy(want_out.copy())

    def run(jax_fn, port_fn):
        with jax.disable_jit(), monkeypatch.context() as mp:
            mp.setattr(jax_common, "fake_quant_act", jax_fq)
            mp.setattr(jax_moe, "fake_quant_act", jax_fq)
            j = jax_fn()
        assert tape
        with monkeypatch.context() as mp:
            mp.setattr(port_common, "fake_quant_act", port_fq)
            mp.setattr(port_moe, "fake_quant_act", port_fq)
            t = port_fn()
        assert not tape, f"{len(tape)} quantizer calls left over"
        return j, t

    yield run


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, size=(b, s)).astype(np.int32)


def test_reduced_config_is_the_issue_shape(models):
    jcfg, *_ = models
    assert (jcfg.layers, jcfg.d_model, jcfg.n_heads, jcfg.head_dim,
            jcfg.d_ff, jcfg.vocab) == (2, 128, 4, 32, 256, 512)


def test_prefill_logits_and_cache(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(jcfg, 2, 9)
    with lockstep(monkeypatch) as run:
        (jl, jc), (tl, tc) = run(
            lambda: japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                                 japi.init_cache(2, 16)),
            lambda: tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tapi.init_cache(2, 16)))
    assert tuple(tl.shape) == (2, 1, jcfg.vocab)
    assert tuple(tc.k.shape) == jc.k.shape == (2, 2, jcfg.kv_heads, 16, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def test_decode_steps_per_slot_positions(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(jcfg, 2, 6, seed=1)
    pos = np.array([6, 3], np.int32)          # slots at different depths
    tok = np.array([7, 11], np.int32)
    with lockstep(monkeypatch) as run:
        (_, jc), (_, tc) = run(
            lambda: japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                                 japi.init_cache(2, 16)),
            lambda: tapi.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 tapi.init_cache(2, 16)))
        for _ in range(3):
            (jl, jc), (tl, tc) = run(
                lambda: japi.decode(jp, jnp.asarray(tok), jc,
                                    jnp.asarray(pos)),
                lambda: tapi.decode(tp, torch.from_numpy(tok), tc,
                                    torch.from_numpy(pos)))
            assert tuple(tl.shape) == (2, 1, jcfg.vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
            np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
            tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
            pos = pos + 1


def test_train_shaped_forward(models, monkeypatch):
    jcfg, japi, jp, tapi, tp = models
    toks = _tokens(jcfg, 2, 12, seed=2)
    with lockstep(monkeypatch) as run:
        jl, tl = run(
            lambda: japi.train_logits(jp, {"tokens": jnp.asarray(toks)}),
            lambda: tapi.train_logits(tp, {"tokens": torch.from_numpy(toks)}))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_quantizers_on_identical_inputs():
    """Activation quantizers (a max-reduction: order-free) are bit-exact;
    the weight scale is a mean, summed in another order by XLA and ATen,
    so it agrees to float32 rounding while the ternary grid is exact."""
    x = np.random.default_rng(4).standard_normal((6, 40)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(port_bitnet.fake_quant_act(tx).numpy(),
                                  np.asarray(jax_bitnet.fake_quant_act(jx)))
    (jq, js), (tq, ts) = (jax_bitnet.quantize_act_int8(jx),
                          port_bitnet.quantize_act_int8(tx))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    (jq, jg), (tq, tg) = (jax_bitnet.quantize_weight_ternary(jx),
                          port_bitnet.quantize_weight_ternary(tx))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(port_bitnet.fake_quant_weight(tx).numpy(),
                               np.asarray(jax_bitnet.fake_quant_weight(jx)),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hubert-xlarge",
                                  "internvl2-76b"])
def test_moe_encoder_vlm_families_build(arch):
    """The moe, encoder and vlm families build, and their parameter trees
    have the JAX package's keys, shapes and types (the MoE experts and
    the audio frontend included; their parity is in test_torch_moe.py and
    test_torch_frontends.py)."""
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jcfg = reduced(get_config(arch))
    want = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    got = build_model(tcfg, device="cpu").init(0)
    flat_want = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_got = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_got.keys() == flat_want.keys()
    for key, leaf in flat_want.items():
        assert tuple(flat_got[key].shape) == leaf.shape, key
        assert str(flat_got[key].dtype)[6:] == str(leaf.dtype), key


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_and_hybrid_families_build(arch):
    """The ssm and hybrid families build (their parity is in
    tests/test_torch_hybrid.py)."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    api = build_model(cfg, device="cpu")
    assert api.cfg is cfg and api.decode is not None


def test_long_self_attention_takes_flash_path(monkeypatch):
    """Self-attention over more than FLASH_THRESHOLD tokens goes through
    the flash wrapper (the kernel on the card, its plain version here) and
    equals the masked softmax; shorter prompts stay on the einsum path."""
    import repro_torch.models.attention as att

    calls = []
    flash = att.flash_attention
    monkeypatch.setattr(att, "flash_attention",
                        lambda *a, **k: (calls.append(1), flash(*a, **k))[1])
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4096, h, 8)).astype(
        np.float32)) for h in (2, 1, 1))
    out = att._sdpa(q, k, v, causal=True)
    assert calls == [1] and tuple(out.shape) == (1, 4096, 2, 8)
    scores = torch.einsum("bshd,btd->bhst", q, k[:, :, 0]) / 8 ** 0.5
    scores = scores.masked_fill(
        torch.ones(4096, 4096, dtype=torch.bool).triu(1), -1e30)
    want = torch.einsum("bhst,btd->bshd", torch.softmax(scores, -1),
                        v[:, :, 0])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    att._sdpa(q[:, :2048], k[:, :2048], v[:, :2048], causal=True)
    assert calls == [1]
