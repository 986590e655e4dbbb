"""An ATen-level cost counter over one traced call: the counterpart of the
JAX package's loop-aware HLO cost analysis (``repro.launch.hlo_cost``; the
name is kept so that a reader finds it).

:class:`CostCounter` is a ``TorchDispatchMode`` that sees every ATen op a
call runs on one device and adds up

    flops        from ``torch.utils.flop_counter``'s formulas, the same
                 that ``FlopCounterMode`` applies (matmuls, convolutions,
                 attention), plus the formulas the hand-written kernels
                 register for their custom ops (``kernels/*/ops.py``),
                 a causal flash launch on a query shard charged as its
                 axis's last shard (:func:`_slowest_shard`);
    bytes        each op's operand and result bytes; a view moves none,
                 and a kernel launch is charged by its byte formula (what
                 the kernel reads and writes once, ``kernels/cost.py``),
                 the JAX package's "kernel-adjusted" memory, here exact;
    collectives  the operand bytes of every functional collective
                 (all-gather, all-reduce, reduce-scatter, all-to-all), by
                 kind and by the mesh axis whose process group it runs on;
    per-op-family attribution (``by_op``), in place of the JAX package's
                 per-computation one: where the cost lives;
    memory       the bytes of the live storages and their peak: an op's
                 output whose storage is new and that aliases none of its
                 inputs (by the op's schema) allocates its storage's
                 bytes; a view, or a collective's wait (which on fake
                 tensors returns a new tensor of the same data), joins the
                 allocation of its input; and an allocation is freed when
                 its last storage dies (a weak reference's callback, when
                 the storage's last owner, a tensor or autograd's saved
                 copy, lets go).  This is what the card's caching
                 allocator counts, without its rounding, and it reads the
                 same on fake tensors as on real ones.

Eager loops unroll, so there are no trip counts to recover.  An op on
DTensors is not counted itself: the counter steps aside and counts the
local ops DTensor runs on this rank's shards and the collectives it issues
(``FlopCounterMode`` around a DTensor matmul counts the global product).
So the counts are one device's, replicated redundant work included, as
the JAX package's per-device HLO counts are.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable, Optional

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import COLLECTIVES

_IGNORED = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}

# ops that allocate without writing, and views that the schema does not
# mark as aliasing: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor", "lift_fresh",
             "_unsafe_view", "_reshape_alias", "device"}
# ops whose output shares the storage of their first input where the
# schema does not say so (a collective's wait returns the tensor it waited
# for; on fake tensors, a new tensor of it)
_UNMARKED_VIEWS = {"_unsafe_view", "_reshape_alias", "wait_tensor"}

_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def kernel_bytes():
    """Op overload packet -> byte formula of every hand-written kernel's
    custom op."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd

    return {**fa.BYTES, **ssd.BYTES}


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size())


def _tensors(tree):
    """The tensors of a tree of lists, tuples and dicts, in order.  (A
    recursive closure here would be a reference cycle holding the list of
    tensors, which would then live until the cycle collector runs.)"""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


class _Allocation:
    __slots__ = ("nbytes", "storages")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.storages = 0


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, type) and issubclass(t, DTensor)


class CostCounter(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and collectives of the ops run
    under it (see the module docstring).  ``axis_of_group`` maps a process
    group's name to the mesh axis it spans (:func:`axis_names`)."""

    def __init__(self, axis_of_group: Optional[Dict[str, str]] = None):
        super().__init__()
        self.axis_of_group = dict(axis_of_group or {})
        self.kernel_bytes = kernel_bytes()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.by_axis: Dict[str, float] = {}
        self.by_op: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        # id of a live storage -> (its allocation, a weak reference whose
        # callback lets the storage go)
        self._storages: Dict[int, tuple] = {}
        self._entered = False
        self._fake_mode = None

    def __enter__(self):
        # the fake mode of the first entry (None on real tensors): the mode
        # enters itself again inside ops, maybe under another fake mode
        if not self._entered:
            self._entered = True
            self._fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _IGNORED:
            return NotImplemented
        if any(_is_dtensor_type(t) for t in types):
            # let DTensor run its local ops and collectives, and count those
            return NotImplemented
        packet = func._overloadpacket
        if (packet not in flop_registry
                and func is not torch.ops.prim.device.default):
            # as FlopCounterMode does: decompose what has no formula
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops under a fake mode of its
        # own to learn output shapes: those run on no device
        if active_fake_mode() is self._fake_mode:
            self._count(func, packet, args, kwargs, out)
            self._allocate(func, args, kwargs, out)
        return out

    # -- memory ------------------------------------------------------------ #

    def track_external(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count ``tensors``' storages as live from now on (the step's
        arguments, allocated before it)."""
        for t in tensors:
            self._join(t, None)

    def bytes_of(self, tensors: Iterable[torch.Tensor],
                 exclude: Iterable[torch.Tensor] = ()) -> int:
        """Bytes of the distinct allocations that hold ``tensors``, those
        holding ``exclude`` left out; an untracked storage counts its own
        bytes."""
        seen = {id(self._allocation_of(t)) for t in exclude}
        total = 0
        for t in tensors:
            a = self._allocation_of(t)
            if id(a) not in seen:
                seen.add(id(a))
                total += a.nbytes
        return total

    def _allocation_of(self, t) -> _Allocation:
        st = t.untyped_storage()
        entry = self._storages.get(id(st))
        return entry[0] if entry is not None else _Allocation(st.nbytes())

    def _join(self, t, allocation: Optional[_Allocation]) -> None:
        """Track ``t``'s storage as a holder of ``allocation`` (a new one of
        the storage's bytes when None), unless it is tracked already."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        if allocation is None:
            allocation = _Allocation(st.nbytes())
            self.live_bytes += allocation.nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        allocation.storages += 1
        self._storages[key] = (allocation, weakref.ref(
            st, lambda _, key=key: self._release(key)))

    def _release(self, key: int) -> None:
        allocation, _ = self._storages.pop(key)
        allocation.storages -= 1
        if allocation.storages == 0:
            self.live_bytes -= allocation.nbytes

    def _allocate(self, func, args, kwargs, out) -> None:
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) and len(returns) > 1 \
            else (out,)
        view = func._overloadpacket.__name__ in _UNMARKED_VIEWS
        for ret, value in zip(returns, outs):
            source = None
            if view or ret.alias_info is not None:
                # a view joins the allocation of the tensor it views (its
                # first tensor input); an in-place or out= op returns a
                # tensor that is tracked already
                first = next(iter(_tensors((args, kwargs))), None)
                entry = (self._storages.get(id(first.untyped_storage()))
                         if first is not None else None)
                if entry is None:
                    continue        # a view of something untracked
                source = entry[0]
            for t in _tensors(value):
                if not _is_dtensor_type(type(t)):
                    self._join(t, source)

    def _count(self, func, packet, args, kwargs, out) -> None:
        name = packet.__name__
        args, kwargs = _slowest_shard(func, args, kwargs)
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        kind = (_FUNCOL.get(name) if getattr(
            packet, "_qualified_op_name", "").startswith("_c10d_functional")
            else None)
        if kind is not None:
            moved = sum(_nbytes(t) for t in _tensors(args))
            self.collectives[kind] += moved
            axis = self.axis_of_group.get(_group_name(args, kwargs), "?")
            self.by_axis[axis] = self.by_axis.get(axis, 0.0) + moved
            nbytes = 0.0
        elif packet in self.kernel_bytes:
            nbytes = float(self.kernel_bytes[packet](*args, **kwargs))
        elif func.is_view or name in _NO_BYTES:
            nbytes = 0.0
        else:
            nbytes = (sum(_nbytes(t) for t in _tensors(args))
                      + sum(_nbytes(t) for t in _tensors(kwargs))
                      + sum(_nbytes(t) for t in _tensors(out)))
        self.flops += flops
        self.bytes += nbytes
        fam = self.by_op.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        fam["calls"] += 1
        fam["flops"] += flops
        fam["bytes"] += nbytes

    def summary(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "by_axis": dict(self.by_axis),
                "by_op": {k: dict(v) for k, v in self.by_op.items()}}


def _slowest_shard(func, args, kwargs):
    """A causal flash launch on a query shard of its keys (context
    parallelism: fewer queries than keys, ``q_offset`` the shard's first
    position) is charged as the last shard of its axis, at ``q_offset =
    sk - sq``: that shard sees the most (query, key) pairs and the step
    waits for it, while the traced rank 0 holds the first, which sees the
    fewest.  Other ops pass unchanged."""
    names = [a.name for a in func._schema.arguments]
    if "q_offset" not in names or "causal" not in names:
        return args, kwargs
    bound = dict(zip(names, args), **kwargs)
    if not bound["causal"] or "q_offset" not in bound:
        return args, kwargs
    sq, sk = bound["q"].shape[2], bound["k"].shape[2]
    bound["q_offset"] = max(bound["q_offset"], sk - sq)
    return (tuple(bound[n] for n in names[:len(args)]),
            {n: bound[n] for n in kwargs})


def _group_name(args, kwargs) -> str:
    if "group_name" in kwargs:
        return str(kwargs["group_name"])
    names = [a for a in args if isinstance(a, str)]
    return names[-1] if names else "?"


def axis_names(device_mesh) -> Dict[str, str]:
    """Process-group name -> mesh axis name, for every axis of
    ``device_mesh``."""
    return {device_mesh.get_group(i).group_name: name
            for i, name in enumerate(device_mesh.mesh_dim_names)}
