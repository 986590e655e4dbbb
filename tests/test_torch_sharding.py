"""Port parity: repro_torch.distributed.sharding and launch.mesh against
repro.distributed.sharding and repro.launch.mesh.

Rule tables, parameter rule tables and every parameter's spec must equal
the JAX package's for all 12 registry architectures, on the production
(16, 16) and (2, 16, 16) meshes, in every shape cell.  Meshes are
device-free on both sides (``abstract_mesh``); the parameter shapes are
the JAX models' ``jax.eval_shape`` trees, so no full-size weight is made.
"""
import jax
import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.distributed import sharding as jsh
from repro.models import build_model as jax_build
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _spec(p):
    """A JAX PartitionSpec as the port's spec: its tuple of entries."""
    return tuple(p)


def _table(rules):
    return dict(rules.table)


def _param_table(table):
    return None if table is None else [(pat, _spec(s)) for pat, s in table]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_make_rules_equal_for_every_arch_and_shape(mesh):
    shape, axes = MESHES[mesh]
    jm, tm = jsh.abstract_mesh(shape, axes), tsh.abstract_mesh(shape, axes)
    assert dict(jm.shape) == tm.shape and tuple(jm.axis_names) == \
        tm.axis_names
    for name in tconfigs.arch_names():
        for cell in tconfigs.ALL_SHAPES:
            jr = jsh.make_rules(jconfigs.get_config(name), jm,
                                jconfigs.shape_by_name(cell.name))
            tr = tsh.make_rules(tconfigs.get_config(name), tm, cell)
            assert _table(tr) == _table(jr), (name, cell.name)
            assert tr.param_table == _param_table(jr.param_table), \
                (name, cell.name)
            logical = ("batch", "seq", "heads", None)
            assert tr.spec(*logical) == _spec(jr.spec(*logical))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_shardings_equal_for_every_arch(mesh, fsdp):
    shape, axes = MESHES[mesh]
    jm, tm = jsh.abstract_mesh(shape, axes), tsh.abstract_mesh(shape, axes)
    assert len(tconfigs.arch_names()) == 12
    for name in tconfigs.arch_names():
        shapes = _shapes(name)
        want = jsh.param_shardings(jconfigs.get_config(name), jm, shapes,
                                   fsdp=fsdp)
        got = tsh.param_shardings(tconfigs.get_config(name), tm, shapes,
                                  fsdp=fsdp)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_w) > 0
        for path, sharding in flat_w:
            node = got
            for p in path:
                node = node[p.key]
            assert node == _spec(sharding.spec), (name, path)


_SHAPES = {}


def _shapes(name):
    if name not in _SHAPES:
        api = jax_build(jconfigs.get_config(name))
        _SHAPES[name] = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    return _SHAPES[name]


def test_spec_dedupes_repeated_axes():
    table = {"seq": "model", "heads": "model", "batch": ("pod", "data")}
    shape, axes = MESHES["multi_pod"]
    jr = jsh.Rules(jsh.abstract_mesh(shape, axes), table)
    tr = tsh.Rules(tsh.abstract_mesh(shape, axes), table)
    for logical in (("batch", "seq", "heads", None),
                    ("heads", "seq"), ("batch", "batch"), (None, "seq")):
        assert tr.spec(*logical) == _spec(jr.spec(*logical))
    assert tr.spec("batch", "seq", "heads", None) == (
        ("pod", "data"), "model", None, None)


def test_legion_rules_equal():
    for axes in (("legion",), ("data", "legion"), ("data",)):
        shape = (4,) * len(axes)
        jr = jsh.legion_rules(jsh.abstract_mesh(shape, axes))
        tr = tsh.legion_rules(tsh.abstract_mesh(shape, axes))
        assert _table(tr) == _table(jr)
        for logical in (("legion", "round", "m", "k"), ("m", "k"),
                        ("legion", "round", "k", "n")):
            assert tr.spec(*logical) == _spec(jr.spec(*logical))


def test_spec_for_path_and_fit():
    cfg_j = jconfigs.get_config("internvl2-76b")
    cfg_t = tconfigs.get_config("internvl2-76b")
    shape, axes = MESHES["pod"]
    jm, tm = jsh.abstract_mesh(shape, axes), tsh.abstract_mesh(shape, axes)
    jt = jsh._param_rule_table(cfg_j, jm, True)
    tt = tsh._param_rule_table(cfg_t, tm, True)
    for path, dims in (("attn/wq", (8192, 8192)), ("attn/q_norm", (128,)),
                       ("mlp/w2", (28672, 8192)), ("nothing", (3, 5)),
                       ("ln_f/scale", (8192,)), ("moe/w1", (8, 4, 2))):
        assert tsh.spec_for_path(path, dims, tt) == _spec(
            jsh.spec_for_path(path, dims, jt))
        assert tsh._fit_spec(tm, (17, 32), ("data", "model")) == _spec(
            jsh._fit_spec(jm, (17, 32), jax.sharding.PartitionSpec(
                "data", "model")))


def test_production_meshes():
    for multi in (False, True):
        t = tmesh.make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        assert (t.axis_sizes, t.axis_names) == (shape, axes)
        assert t.size == (512 if multi else 256)
    host = tmesh.make_host_mesh((2, 2, 2), ("a", "b", "c"))
    assert host.shape == {"a": 2, "b": 2, "c": 2}
    with pytest.raises(ValueError):
        tmesh.make_host_mesh((2, 2), ("a", "a"))
    with pytest.raises(ValueError):
        tmesh.make_host_mesh((2,), ("a", "b"))


def test_constrain_without_rules_or_dtensor_is_the_identity():
    import torch

    x = torch.ones((2, 2))
    assert tsh.constrain(x, "batch", "seq") is x
    rules = tsh.make_rules(tconfigs.get_config("bitnet-1.58b"),
                           tsh.abstract_mesh(*MESHES["pod"]),
                           tconfigs.shape_by_name("train_4k"))
    with tsh.use_rules(rules):
        assert tsh.active_rules() is rules
        assert tsh.constrain(x, "batch", "seq") is x
        with pytest.raises(ValueError, match="rank"):
            tsh.constrain(x, "batch")
        layer = {"attn": {"wq": x}}
        assert tsh.constrain_layer_params(layer)["attn"]["wq"] is x
    assert tsh.active_rules() is None
    assert tsh.constrain_layer_params(layer) is layer


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    tr = tsh.Rules(tsh.abstract_mesh(*MESHES["multi_pod"]),
                   {"batch": ("pod", "data"), "seq": "model"})
    assert tr.placements("batch", "seq", None) == [Shard(0), Shard(0),
                                                  Shard(1)]
    assert tr.placements(None, "seq") == [Replicate(), Replicate(),
                                          Shard(1)]


def test_train_step_with_grad_shardings_leaves_plain_tensors():
    """build_train_step(grad_shardings=param_shardings(...)): the specs
    walk the gradient tree leaf by leaf, and plain tensors (one device)
    come out as they went in: the step equals the step without them, bit
    for bit."""
    import torch

    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train import AdamW, build_train_step, init_train_state
    from repro_torch.train.optimizer import tree_leaves

    cfg = tconfigs.reduced(tconfigs.get_config("bitnet-1.58b")).replace(
        dtype="float32", quantization="none")
    api = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3)
    state = init_train_state(api, opt, 0)
    specs = tsh.param_shardings(cfg, tsh.abstract_mesh(*MESHES["pod"]),
                                state.params, fsdp=True)
    assert specs["blocks"]["attn"]["wq"][0] is None
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, batch=2, seq=32, step=0).items()}
    plain, m_plain = build_train_step(api, opt)(state, batch)
    pinned, m_pinned = build_train_step(api, opt, grad_shardings=specs)(
        state, batch)
    assert float(m_plain["loss"]) == float(m_pinned["loss"])
    for a, b in zip(tree_leaves(plain), tree_leaves(pinned)):
        assert torch.equal(a, b)
