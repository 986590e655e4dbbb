"""Logical-axis sharding rules, the port of ``repro.distributed.sharding``.

The paper maps attention heads onto Legions, multicasts the input matrix to
all Legions, and replicates KV tiles across GQA groups.  As sharding rules
the same decisions read:

    heads -> "model" mesh axis        (a Legion = a model-parallel shard)
    batch -> ("pod", "data")          (independent workloads = data parallel)
    KV with kv_heads < model size     -> replicated (the KV multicast)
    out-proj / FFN  N-partitioning    -> column/row-parallel TP
    MoE experts -> "model"            (expert parallelism)
    long-context decode: sequence -> "data" (flash-decoding style split)

A rule table maps *logical* axis names to mesh axes (or None).  A spec is
a tuple with one entry per tensor dimension, each a mesh axis name, a
tuple of them, or None: the entries of the JAX package's
``PartitionSpec``, so the two compare directly.  :meth:`Rules.placements`
turns a spec into DTensor placements (``Shard`` / ``Replicate``) on a
``DeviceMesh`` of the rules' mesh.

Without an active rule table :func:`constrain` is the identity; with one,
it redistributes a DTensor to the spec and returns a plain tensor as it
is.  The port's models call it where the JAX models do, so that on
DTensor parameters (placed by :func:`place_params`, the counterpart of
``jax.jit``'s ``in_shardings``) their activations take the JAX package's
layouts; on plain tensors it changes nothing.

Parameter specs are path-regex driven (:func:`param_shardings`): 2-D (fsdp
x tensor) sharding for large architectures, tensor-parallel for small
ones.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.launch.mesh import MeshSpec, abstract_mesh

__all__ = [
    "Rules", "Spec", "abstract_mesh", "active_rules", "constrain",
    "constrain_layer_params", "legion_rules", "make_rules",
    "param_shardings", "place_params", "settle", "spec_for_path",
    "use_rules",
]

# one entry per tensor dimension: a mesh axis, a tuple of them, or None
Spec = Tuple[Optional[object], ...]


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,) if entry else ()


class Rules:
    """Active sharding rules: logical axis -> mesh axis (or None)."""

    def __init__(self, mesh: MeshSpec, table: Dict[str, Optional[object]],
                 param_table=None):
        self.mesh = mesh
        self.table = table
        self.param_table = param_table
        self._device_meshes: Dict[str, object] = {}

    def axis_group(self, axis: str, device_type: str):
        """(process group, this rank's index along ``axis``) of mesh axis
        ``axis``, from a ``DeviceMesh`` of this mesh over the default group
        (made once per device type; the default group's world size must be
        the mesh's size)."""
        if device_type not in self._device_meshes:
            from repro_torch.launch.mesh import device_mesh

            self._device_meshes[device_type] = device_mesh(self.mesh,
                                                           device_type)
        dm = self._device_meshes[device_type]
        return dm.get_group(axis), dm.get_local_rank(axis)

    def spec(self, *logical: Optional[str]) -> Spec:
        entries = [self.table.get(a) if a else None for a in logical]
        # a mesh axis may appear at most once in a spec: keep the first
        # use, drop later duplicates (e.g. seq->model + heads->model)
        used: set = set()
        out = []
        for e in entries:
            axes = _axes(e)
            if any(a in used for a in axes):
                out.append(None)
                continue
            used.update(axes)
            out.append(e)
        return tuple(out)

    def placements(self, *logical: Optional[str]) -> list:
        """DTensor placements of :meth:`spec` on a ``DeviceMesh`` of this
        mesh, one per mesh axis: ``Shard(dim)`` where the spec puts that
        axis on tensor dimension ``dim``, else ``Replicate()``."""
        return spec_placements(self.mesh, self.spec(*logical))


def spec_placements(mesh: MeshSpec, spec: Spec) -> list:
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {a: d for d, e in enumerate(spec) for a in _axes(e)}
    return [Shard(dim_of[a]) if a in dim_of else Replicate()
            for a in mesh.axis_names]


_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "sharding_rules", default=None
)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def active_rules() -> Optional[Rules]:
    return _ACTIVE.get()


def local_extent(x) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of the DTensor
    ``x``, from its placements (``Shard`` cuts ``torch.chunk``'s way,
    mesh dimension after mesh dimension).  In plain integers, so that it
    works on fake tensors too (DTensor's own helper indexes a tensor)."""
    shape, start = list(x.shape), [0] * x.ndim
    coord = x.device_mesh.get_coordinate()
    for i, pl in enumerate(x.placements):
        if not pl.is_shard():
            continue
        d, n = pl.dim, x.device_mesh.size(i)
        piece = -(-shape[d] // n)
        lo = min(coord[i] * piece, shape[d])
        start[d] += lo
        shape[d] = min(piece, shape[d] - lo)
    return tuple(shape), tuple(start)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def redistribute(x, spec: Spec):
    """A DTensor laid out by ``spec`` on its own device mesh (whose
    dimension names are the spec's mesh axes); a plain tensor as it is."""
    if not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    if mesh.mesh_dim_names is None:
        raise ValueError("a DTensor laid out by a spec needs a DeviceMesh "
                         "with dimension names (launch.mesh.device_mesh)")
    names = tuple(mesh.mesh_dim_names)
    return x.redistribute(mesh, spec_placements(
        MeshSpec(names, tuple(mesh.shape)), spec))


def settle(x):
    """A DTensor holding partial sums (a vocab-parallel embedding's
    lookup, a row-parallel product) reduced to replicated values along
    those mesh axes; a plain tensor, or a DTensor with no partial
    placement, as it is."""
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def constrain(x, *logical: Optional[str]):
    """Constrain ``x``'s layout by logical axis names: the identity without
    rules or on a plain tensor, a redistribution of a DTensor (a mesh axis
    that does not divide its dimension is left out, as for parameters: a
    decode step's one position stays whole)."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank {x.ndim} vs {logical}")
    if not _is_dtensor(x):
        return x
    return redistribute(x, _fit_spec(rules.mesh, tuple(x.shape),
                                     rules.spec(*logical)))


# --------------------------------------------------------------------------- #
# Legion-axis rules (Machine's ShardedExecutor)
# --------------------------------------------------------------------------- #

def legion_rules(mesh: MeshSpec, *, axis: str = "legion") -> Rules:
    """Rule table for Legion-parallel plan execution.

    A StagePlan's **legion** axis lands on a mesh axis (a Legion = one
    device shard, the correspondence ``make_rules`` draws for heads ->
    "model"); every other runtime tensor axis (the round slot within a
    Legion, the streamed M rows, the K reduction, the N columns) stays
    local to the device.  ``repro_torch.legion.machine.ShardedExecutor``
    splits its stacked operands by this table.
    """
    table: Dict[str, Optional[object]] = {
        "legion": axis if axis in mesh.axis_names else None,
        "round": None,
        "m": None,
        "k": None,
        "n": None,
    }
    return Rules(mesh, table)


# --------------------------------------------------------------------------- #
# Rule construction per (arch, shape, mesh)
# --------------------------------------------------------------------------- #

def _axis_size(mesh: MeshSpec, axis) -> int:
    size = 1
    for a in _axes(axis):
        size *= mesh.shape[a]
    return size


def _divisible(n: int, mesh: MeshSpec, axis: object) -> bool:
    if axis is None:
        return False
    return n % _axis_size(mesh, axis) == 0


def make_rules(cfg, mesh: MeshSpec, shape) -> Rules:
    """Build the activation rule table for a (ModelConfig, ShapeConfig)."""
    axes = set(mesh.axis_names)
    batch_axes: Tuple = tuple(a for a in ("pod", "data") if a in axes)
    batch_axis = batch_axes if len(batch_axes) > 1 else (
        batch_axes[0] if batch_axes else None
    )
    model_axis = "model" if "model" in axes else None
    msize = mesh.shape.get("model", 1)

    table: Dict[str, Optional[object]] = {
        "batch": batch_axis if _divisible(shape.global_batch, mesh,
                                          batch_axis) else None,
        "seq": None,
        "embed": None,
        "ff": model_axis if _divisible(cfg.d_ff or cfg.d_inner, mesh,
                                       model_axis) else None,
        "vocab": model_axis,   # uneven vocab sharding is padded
        "heads": model_axis if cfg.n_heads and cfg.n_heads % msize == 0
        else None,
        "kv_heads": model_axis if cfg.kv_heads and cfg.kv_heads % msize == 0
        else None,             # None = replicated KV = the paper's multicast
        "ssm_heads": model_axis if cfg.family in ("ssm", "hybrid")
        and cfg.ssm_heads % msize == 0 else None,
        "experts": model_axis if cfg.n_experts and
        cfg.n_experts_total % msize == 0 else None,
        "expert_cap": batch_axis,   # MoE capacity dim rides the batch axes
        "ssm_state": None,
        "d_inner": model_axis if cfg.family in ("ssm", "hybrid") and
        _divisible(cfg.d_inner, mesh, model_axis) else None,
    }
    # MoE with sharded experts: the per-expert FFN dim must not also land on
    # the model axis (a spec may not repeat an axis).
    if cfg.n_experts and table["experts"] is not None:
        table["ff"] = None
    # Context/sequence parallelism for attention-dominant families: the seq
    # dim takes the model axis, attention runs per query shard against
    # replicated (multicast) KV, and heads stay local.  SSM/hybrid stacks
    # keep their sequential chunk scans unsharded instead.
    if shape.kind in ("train", "prefill") and model_axis and \
            shape.seq_len % (msize * 128) == 0 and \
            cfg.family in ("dense", "moe", "encoder", "vlm"):
        table["seq"] = model_axis
        table["heads"] = None
        table["kv_heads"] = None
    # Long-context decode: batch tiny, KV sequence is the big axis: shard it
    # over the data axis (flash-decoding style partial-softmax combine).
    if shape.kind == "decode" and shape.global_batch < _axis_size(mesh,
                                                                  batch_axis):
        table["batch"] = None
        table["seq"] = "data" if "data" in axes else None
    fsdp = cfg.param_count() >= 3_000_000_000
    return Rules(mesh, table,
                 param_table=_param_rule_table(cfg, mesh, fsdp)
                 if shape.kind == "train" else None)


# --------------------------------------------------------------------------- #
# Parameter shardings (path-regex -> spec)
# --------------------------------------------------------------------------- #

def _param_rule_table(cfg, mesh: MeshSpec,
                      fsdp: bool) -> List[Tuple[str, Spec]]:
    """Ordered (regex, spec) table; first match wins.

    ``fsdp`` additionally shards the non-TP dimension over "data"
    (2-D weight sharding for >= ~7B archs).
    """
    m = "model" if "model" in mesh.axis_names else None
    d = "data" if (fsdp and "data" in mesh.axis_names) else None
    msize = mesh.shape.get("model", 1)
    heads_ok = cfg.n_heads and cfg.n_heads % msize == 0
    kv_ok = cfg.kv_heads and cfg.kv_heads % msize == 0
    experts_ok = cfg.n_experts and cfg.n_experts_total % msize == 0
    return [
        # embeddings / lm head: vocab-parallel only
        (r"embed/tokens$", (m, None)),
        (r"lm_head$", (None, m)),
        (r"frontend/.*", (None, None)),
        # attention: column-parallel QKV, row-parallel out
        (r"attn/wq$", (d, m if heads_ok else None)),
        (r"attn/wk$", (d, m if kv_ok else None)),
        (r"attn/wv$", (d, m if kv_ok else None)),
        (r"attn/wo$", (m if heads_ok else None, d)),
        (r"attn/(q_norm|k_norm)$", (None,)),
        # dense mlp: swiglu column/row parallel
        (r"mlp/w(1|3)$", (d, m)),
        (r"mlp/w2$", (m, d)),
        # moe: expert parallelism on the leading expert dim
        (r"moe/router$", (None, None)),
        (r"moe/w(1|3)$", (m if experts_ok else None, d,
                          None if experts_ok else m)),
        (r"moe/w2$", (m if experts_ok else None,
                      None if experts_ok else m, d)),
        # mamba2 / ssd
        (r"ssm/in_proj", (d, m)),
        (r"ssm/out_proj$", (m, d)),
        (r"ssm/(conv_w|conv_b)$", (None, m)),
        (r"ssm/(a_log|dt_bias|d_skip)$", (m,)),
        (r"ssm/norm$", (m,)),
        # norms and everything 1-D: replicate
        (r".*(norm|ln_f|scale|bias).*", (None,)),
    ]


def spec_for_path(path: str, shape: Tuple[int, ...], table) -> Spec:
    """The first matching rule's spec, cut or padded with None to the
    leaf's rank; a leaf no rule matches is replicated."""
    for pat, spec in table:
        if re.search(pat, path):
            return tuple(list(spec)[: len(shape)]
                         + [None] * max(0, len(shape) - len(spec)))
    return (None,) * len(shape)


def _fit_spec(mesh: MeshSpec, shape, spec) -> Spec:
    """Trim/pad spec to rank; drop axes that don't divide the dim."""
    entries = list(spec)[: len(shape)] + [None] * max(
        0, len(shape) - len(spec)
    )
    return tuple(ax if ax is not None and dim % _axis_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, entries))


def _tree_with_paths(fn, tree, prefix=""):
    """``fn(path, leaf)`` over nested dicts, keys joined by "/" as the JAX
    package's key paths are."""
    if isinstance(tree, dict):
        return {k: _tree_with_paths(fn, v, f"{prefix}/{k}" if prefix
                                    else str(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_shardings(cfg, mesh: MeshSpec, params_shape, *,
                    fsdp: bool = False):
    """Tree of specs matching ``params_shape`` (nested dicts whose leaves
    have a ``.shape``: tensors, meta tensors, or shape structs).

    Leaves under ``blocks/`` are layer-stacked ``[L, ...]``: the spec
    applies from dim 1 and the layer dim stays unsharded.
    """
    table = _param_rule_table(cfg, mesh, fsdp)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_path(path, shape, table)
        if "blocks/" in path:
            spec = (None,) + spec
        return _fit_spec(mesh, shape, spec)

    return _tree_with_paths(assign, params_shape)


def constrain_layer_params(layer_params, cfg=None, *, fsdp: bool = True):
    """One layer's parameters laid out by the active rules' parameter
    table: DTensor leaves are redistributed to their spec, plain tensors
    returned as they are; without rules (or outside a train shape) the
    tree is returned unchanged."""
    rules = _ACTIVE.get()
    if rules is None or rules.param_table is None:
        return layer_params

    def assign(path, leaf):
        if not _is_dtensor(leaf):
            return leaf
        return redistribute(leaf, _fit_spec(
            rules.mesh, tuple(leaf.shape),
            spec_for_path(path, tuple(leaf.shape), rules.param_table)))

    return _tree_with_paths(assign, layer_params)


def place_params(params, mesh: MeshSpec, specs, device_mesh):
    """``params`` (nested dicts of tensors, each holding the whole leaf)
    as DTensors on ``device_mesh`` (a ``DeviceMesh`` of ``mesh``), each
    leaf laid out by its spec in ``specs`` (a tree like
    :func:`param_shardings`'): every rank keeps its own shard, cut from
    the leaf it holds, and nothing is sent (every rank must hold the same
    values, as ranks seeded alike do).  A leaf that is a DTensor already
    is redistributed to its spec."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(params, dict):
        return {k: place_params(v, mesh, specs[k], device_mesh)
                for k, v in params.items()}
    if params is None:
        return None
    if _is_dtensor(params):
        return redistribute(params, specs)
    return distribute_tensor(params, device_mesh,
                             spec_placements(mesh, specs),
                             src_data_rank=None)
