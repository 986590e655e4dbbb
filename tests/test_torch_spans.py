"""The train step's wall-clock spans (``repro_torch.obs.spans``) under
``torch.profiler`` on the CPU, on reduced BitNet (two-level remat) and a
reduced hybrid (a shared attention block and Mamba blocks, every period
but the last remat'd): each span's calls a step, counted from the remat
schedule and the model's quantized projections; the backward span holding
every node the autograd engine runs; nothing entered without a profiler;
and no number of the step changed by tracing."""
import collections

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as tconfigs
from repro_torch import train
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.models.common import remat_forwards, remat_groups
from repro_torch.models.hybrid import n_attn_apps
from repro_torch.obs import spans
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import value_and_grad

# the projections that ``dense(..., quantize=True)`` fake-quantizes, one
# weight and one input each: attention and SwiGLU, and a Mamba-2 block's
ATTN_MLP = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
MAMBA = ("in_proj_z", "in_proj_xbc", "in_proj_dt", "out_proj")
ENGINE_NODE = "autograd::engine::evaluate_function"
ARCHS = ["bitnet-1.58b", "zamba2-7b"]


def _config(arch):
    # bitnet: 4 layers, best_grouping 2, so every layer runs 3 times;
    # zamba2: 3 periods of a shared block and 2 Mamba blocks
    layers = 4 if arch == "bitnet-1.58b" else 6
    return tconfigs.reduced(tconfigs.get_config(arch)).replace(
        dtype="float32", remat="block", layers=layers)


def _setup(arch):
    cfg = _config(arch)
    api = build_model(cfg, device="cpu")
    opt = train.AdamW(lr=1e-3)
    state = train.init_train_state(api, opt, 0)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, batch=2, seq=64, step=0).items()}
    return cfg, api, opt, state, batch


def _keys(tree):
    if isinstance(tree, dict):
        return set(tree) | {k for v in tree.values() for k in _keys(v)}
    return set()


def _expected(cfg, params, grad_accum):
    """Calls a step of each span, from the schedule: BitNet's layers run
    ``remat_forwards`` times, each fake-quantizing its 7 projections; the
    hybrid runs its periods (a shared block, ``attn_every`` Mamba blocks)
    twice where remat'd (all but the last), once otherwise."""
    keys = _keys(params)
    if cfg.family == "hybrid":
        assert set(ATTN_MLP + MAMBA) <= keys
        apps = n_attn_apps(cfg)
        runs = [2] * (apps - 1) + [1]
        per_period = [min(cfg.attn_every, cfg.layers - a * cfg.attn_every)
                      for a in range(apps)]
        fq = sum(r * (len(ATTN_MLP) + len(MAMBA) * n)
                 for r, n in zip(runs, per_period))
        layers = apps + cfg.layers
        recompute = sum(1 + n for r, n in zip(runs, per_period) if r == 2)
    else:
        assert set(ATTN_MLP) <= keys and remat_groups(cfg, cfg.layers) > 1
        fq = len(ATTN_MLP) * remat_forwards(cfg, cfg.layers)
        layers = cfg.layers
        recompute = remat_forwards(cfg, cfg.layers) - cfg.layers
    return {spans.FORWARD: grad_accum, spans.BACKWARD: grad_accum,
            spans.OPTIMIZER: 1, spans.LAYER: grad_accum * layers,
            spans.LAYER_RECOMPUTE: grad_accum * recompute,
            spans.FAKE_QUANT_WEIGHT: grad_accum * fq,
            spans.FAKE_QUANT_ACT: grad_accum * fq}


def _traced_step(step, state, batch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(state, batch)
    return out, [e for e in prof.events() if e.device_type == DeviceType.CPU]


@pytest.mark.parametrize("arch,grad_accum", [("bitnet-1.58b", 1),
                                             ("bitnet-1.58b", 2),
                                             ("zamba2-7b", 1)])
def test_each_span_runs_as_often_as_the_schedule_says(arch, grad_accum):
    cfg, api, opt, state, batch = _setup(arch)
    step = train.build_train_step(api, opt, grad_accum=grad_accum)
    _, events = _traced_step(step, state, batch)
    got = collections.Counter(e.name for e in events
                              if e.name.startswith("repro_torch."))
    assert dict(got) == _expected(cfg, state.params, grad_accum)


def _inside(event, name):
    parent = event.cpu_parent
    while parent is not None:
        if parent.name == name:
            return True
        parent = parent.cpu_parent
    return False


@pytest.mark.parametrize("arch", ARCHS)
def test_the_backward_span_holds_every_node_of_the_backward(arch):
    """Every node the engine evaluates, the remat's recomputations among
    them, runs inside ``train.backward`` (which starts and ends on one
    thread, so the profiler nests it); the one exception is the identity
    node that opens the span from inside its own evaluation."""
    _, api, opt, state, batch = _setup(arch)
    step = train.build_train_step(api, opt)
    _, events = _traced_step(step, state, batch)
    backward = [e for e in events if e.name == spans.BACKWARD]
    assert len(backward) == 1 and not backward[0].is_async
    nodes = [e for e in events if e.name.startswith(ENGINE_NODE)]
    outside = [e.name for e in nodes if not _inside(e, spans.BACKWARD)]
    assert outside == [f"{ENGINE_NODE}: _OpenBackwardBackward"]
    assert len(nodes) > 100
    for e in events:
        if e.name == spans.LAYER_RECOMPUTE:
            assert _inside(e, spans.BACKWARD)
        if e.name == spans.LAYER:
            assert _inside(e, spans.FORWARD)


def test_nothing_is_entered_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(spans, "record_function", Counting)
    assert spans.span(spans.FORWARD) is spans.NULL
    assert spans.layer_span() is spans.NULL
    loss = torch.ones((), requires_grad=True) * 2
    assert spans.backward_span(loss) is loss
    for arch in ARCHS:
        _, api, opt, state, batch = _setup(arch)
        train.build_train_step(api, opt)(state, batch)
    assert entered == []


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_changes_no_number_of_the_step(arch):
    """Loss, gradients, the updated parameters and moments: bit-equal with
    the spans recorded and without."""
    _, api, opt, state, batch = _setup(arch)
    step = train.build_train_step(api, opt)
    plain_loss, plain_grads = value_and_grad(api.loss, state.params, batch)
    plain_state, plain_m = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        loss, grads = value_and_grad(api.loss, state.params, batch)
        traced_state, m = step(state, batch)
    assert torch.equal(loss, plain_loss)
    _equal_trees(grads, plain_grads)
    assert torch.equal(m["loss"], plain_m["loss"])
    assert torch.equal(m["grad_norm"], plain_m["grad_norm"])
    _equal_trees(traced_state.params, plain_state.params)
    _equal_trees(traced_state.opt, plain_state.opt)
