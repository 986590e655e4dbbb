"""The plain reference against the port at tiny sizes on the CPU, its
parameter layout against the port's, and the configuration files against
the port's configurations and the published config."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import CELLS, ROOT, TINY
from portbench import reference
from portbench.reference import common
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.train import AdamW, TrainState, build_train_step


def _cell_spec(cell, **kw):
    config = json.loads((ROOT / "portbench" / "configs"
                         / f"{cell.split('.train')[0]}.json").read_text())
    return dict(config["as_run"], **TINY[cell], **kw), config["train"]


def _tree_layout(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_layout(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


@pytest.mark.parametrize("cell", CELLS)
def test_parameter_layout_is_the_ports(cell):
    spec, _ = _cell_spec(cell)
    api = build_model(ModelConfig(**spec), device="cpu")
    fam = reference.load(spec["family"])
    mine = common.build_tree(fam.leaves(spec), 5, "cpu")
    assert _tree_layout(mine) == _tree_layout(api.init(0))


@pytest.mark.parametrize("cell", CELLS)
def test_float32_reference_follows_the_ports_steps(cell):
    spec, opt = _cell_spec(cell, dtype="float32")
    fam = reference.load(spec["family"])
    leaves = fam.leaves(spec)
    api = build_model(ModelConfig(**spec), device="cpu")
    adamw = AdamW(**opt)
    params = common.build_tree(leaves, 9, "cpu")
    state = TrainState(params, adamw.init(params))
    step = build_train_step(api, adamw)
    ref = common.build_tree(leaves, 9, "cpu")
    mu, nu = common.zeros_like_tree(ref), common.zeros_like_tree(ref)
    units = fam.units(spec, common.Precision("float32"))
    gen = torch.Generator().manual_seed(3)
    for i in range(2):
        ids = torch.randint(0, spec["vocab"], (1, 65), generator=gen)
        batch = {"tokens": ids[:, :-1].int(), "targets": ids[:, 1:].int()}
        state, m = step(state, batch)
        loss, grads = common.loss_and_grads(units, ref, batch,
                                            common.Precision())
        assert float(loss) == pytest.approx(float(m["loss"]), rel=1e-5)
        gnorm = common.adamw_step(ref, grads, mu, nu, i + 1, opt, leaves)
        assert float(gnorm) == pytest.approx(float(m["grad_norm"]),
                                             rel=1e-4)
    for leaf in leaves:
        got = common.get(state.params, leaf.path)
        want = common.get(ref, leaf.path)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_configuration_files_are_the_ports_configurations():
    port = {"bitnet-1.58b": get_config("bitnet-1.58b"),
            "zamba2-7b-30l": get_config("zamba2-7b").replace(layers=30)}
    for name, cfg in port.items():
        config = json.loads((ROOT / "portbench" / "configs"
                             / f"{name}.json").read_text())
        assert ModelConfig(**config["as_run"]) == cfg


def test_zamba2_file_keeps_the_published_config_but_its_cuts():
    config = json.loads((ROOT / "portbench" / "configs"
                         / "zamba2-7b-30l.json").read_text())
    published = json.loads((ROOT / "portbench" / "configs"
                            / "zamba2-7b-instruct.published.json")
                           .read_text())
    for key, value in published.items():
        if key in config["reduced"]:
            assert config[key] != value
        else:
            assert config[key] == value, key
    assert config["num_hidden_layers"] == config["as_run"]["layers"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_far_above_the_float32_program(cell):
    """fp8 in the program's place moves every reading well past what the
    float32 program and reference part by."""
    from portbench import compare

    spec, opt = _cell_spec(cell, dtype="float32")
    ids = torch.randint(0, spec["vocab"], (3, 1, 65),
                        generator=torch.Generator().manual_seed(4))
    batches = [{"tokens": t[:, :-1].int(), "targets": t[:, 1:].int()}
               for t in ids]
    from portbench.kinds.train import reference_readings

    base = reference_readings(spec, opt, 8, batches, "cpu")
    control = reference_readings(spec, opt, 8, batches, "cpu", "fp8")
    found = compare.gaps(control, base)
    assert found["loss_gap"]["value"] > 1e-3
    assert found["grad_gap"]["value"] > 1e-2
