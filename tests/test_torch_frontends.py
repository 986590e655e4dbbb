"""Port parity: the encoder (``audio_frames``, hubert-xlarge) and VLM
(``vision_patches``, internvl2-76b) families of repro_torch.models against
repro.models on reduced configs, the same parameters through
params_from_jax; the data pipeline's synthetic batches; which entry points
each family's ModelAPI has.

Tolerance: atol = rtol = 1e-5, compared per layer before quantization with
``lockstep`` (test_torch_models.py) where BitNet quantization is on; the
3072-frame flash-path encoder runs without quantization and is compared
whole at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
import repro_torch.configs as tconfigs
import repro_torch.models.attention as port_attention
from repro.configs import arch_names, get_config, reduced
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models import build_model as jax_build
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from test_torch_models import lockstep

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(arch, **kw):
    jcfg = reduced(get_config(arch)).replace(**kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(**kw)
    japi, tapi = jax_build(jcfg), build_model(tcfg, device="cpu")
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, japi, jp, tapi, tp


def _batch(cfg, b, s, seed=0):
    np_batch = synthetic_batch(cfg, batch=b, seq=s, step=seed)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _close(port_tree, jax_tree):
    for t, j in zip(port_tree, jax_tree):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# --------------------------------------------------------------------------- #
# Encoder: hubert-xlarge
# --------------------------------------------------------------------------- #

def test_encoder_train_logits_and_prefill(monkeypatch):
    """Non-causal self-attention over float32 frames; the encoder-only API
    has no decode and no chunked prefill, and the engine refuses it."""
    jcfg, japi, jp, tapi, tp = _pair("hubert-xlarge", dtype="float32")
    jb, tb = _batch(jcfg, 2, 12)
    with lockstep(monkeypatch) as run:
        jl, tl = run(lambda: japi.train_logits(jp, jb),
                     lambda: tapi.train_logits(tp, tb))
        (jpl, jc), (tpl, tc) = run(
            lambda: japi.prefill(jp, jb, japi.init_cache(2, 16)),
            lambda: tapi.prefill(tp, tb, tapi.init_cache(2, 16)))
        jloss, tloss = run(lambda: japi.loss(jp, jb),
                           lambda: tapi.loss(tp, tb))
    assert tuple(tl.shape) == (2, 12, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), **TOL)
    _close(tc, jc)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
    # bidirectional: the first frame's logits see the last frame
    frames = tb["frames"].clone()
    frames[:, -1] = 5.0
    base = tapi.train_logits(tp, tb)
    moved = tapi.train_logits(tp, {"frames": frames})
    assert not torch.allclose(moved[:, 0], base[:, 0])
    assert tapi.decode is None and tapi.prefill_chunk is None
    with pytest.raises(ValueError, match="encoder-only; no decode"):
        ServeEngine(tapi, tp)


def test_encoder_flash_path_with_promoted_frames(monkeypatch):
    """3072 frames: the JAX encoder's attention takes its chunked flash twin
    (_flash_ref), the port's the flash wrapper (its plain version on the
    CPU), non-causal.  The weights stay bf16 and the frames float32, so
    every product promotes to float32 as JAX's does."""
    jcfg, japi, jp, tapi, tp = _pair("hubert-xlarge", quantization="none")
    assert jcfg.dtype == "bfloat16" and not jcfg.causal
    calls = {"jax": [], "port": []}
    jax_flash = jax_attention._flash_ref
    port_flash = port_attention.flash_attention

    def count(side, fn):
        def wrapped(*a, **k):
            calls[side].append(k["causal"])
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jax_attention, "_flash_ref", count("jax", jax_flash))
    monkeypatch.setattr(port_attention, "flash_attention",
                        count("port", port_flash))
    jb, tb = _batch(jcfg, 1, 3072, seed=3)
    assert tb["frames"].dtype == torch.float32
    jl = japi.train_logits(jp, jb)
    tl = tapi.train_logits(tp, tb)
    assert tl.dtype == torch.float32
    # JAX counts traces of its layer scan, the port calls
    assert calls["jax"] and not any(calls["jax"])
    assert calls["port"] == [False] * jcfg.layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# --------------------------------------------------------------------------- #
# VLM: internvl2-76b
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def vlm():
    return _pair("internvl2-76b", dtype="float32")


def test_vlm_train_logits_and_loss_with_patches(vlm, monkeypatch):
    jcfg, japi, jp, tapi, tp = vlm
    jb, tb = _batch(jcfg, 2, 12 + jcfg.num_patches, seed=1)
    assert tuple(tb["patch_embeds"].shape) == (2, jcfg.num_patches,
                                               jcfg.d_model)
    with lockstep(monkeypatch) as run:
        jl, tl = run(lambda: japi.train_logits(jp, jb),
                     lambda: tapi.train_logits(tp, tb))
        jloss, tloss = run(lambda: japi.loss(jp, jb),
                           lambda: tapi.loss(tp, tb))
    assert tuple(tl.shape) == (2, 12 + jcfg.num_patches, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)


def test_vlm_prefill_with_patches_then_decode(vlm, monkeypatch):
    jcfg, japi, jp, tapi, tp = vlm
    jb, tb = _batch(jcfg, 2, 12 + jcfg.num_patches, seed=2)
    jb = {k: jb[k] for k in ("tokens", "patch_embeds")}
    tb = {k: tb[k] for k in ("tokens", "patch_embeds")}
    s = 12 + jcfg.num_patches
    pos = np.array([s, s], np.int32)
    with lockstep(monkeypatch) as run:
        (jl, jc), (tl, tc) = run(
            lambda: japi.prefill(jp, jb, japi.init_cache(2, s + 4)),
            lambda: tapi.prefill(tp, tb, tapi.init_cache(2, s + 4)))
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


# --------------------------------------------------------------------------- #
# Data pipeline and the registry's entry points, all 12 archs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", arch_names())
def test_synthetic_batch_equals_jax_copy(arch):
    cfg = reduced(get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    seq = 24 if cfg.frontend != "vision_patches" else 24 + cfg.num_patches
    want = jax_synthetic_batch(cfg, batch=2, seq=seq, step=3, seed=7)
    got = synthetic_batch(tcfg, batch=2, seq=seq, step=3, seed=7)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", arch_names())
def test_build_model_entry_points_match_jax(arch):
    """decode and prefill_chunk are present exactly where the JAX package's
    ModelAPI has them, at full size (nothing is allocated until init)."""
    japi = jax_build(get_config(arch))
    tapi = build_model(tconfigs.get_config(arch), device="cpu")
    assert (tapi.decode is None) == (japi.decode is None)
    assert (tapi.prefill_chunk is None) == (japi.prefill_chunk is None)
    assert callable(tapi.loss)
