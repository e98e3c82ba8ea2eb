"""Op-level cost analysis of one step: FLOPs, HBM bytes, collectives.

Port of `repro/launch/hlo_analysis.py`, under the same name so that a
reader finds the counterpart. PyTorch has no HLO: there is no compiled
program text to parse. This module runs the step instead, under a
`TorchDispatchMode`, and counts the aten operations that the step
dispatches, by the reference's rules:

  flops:      matmuls (mm, bmm, addmm, baddbmm, convolution and the
              attention ops) 2 x output elements x contracted size, by
              the formulas of `torch.utils.flop_counter` (the reference's
              `_dot_flops`); elementwise ops 1 an output element (the
              reference's `_ARITH_1`, by their aten names) or 4 (its
              transcendental `_ARITH_4`);
  hbm bytes:  each op's tensor inputs and outputs, once each (an
              in-place op's destination is read and written); a view (an
              op whose outputs alias its inputs) moves nothing, a fill
              writes once, and an in-place windowed write (`index_copy_`,
              `index_put_`; `copy_` into a slice, whose destination is the
              window's view) counts twice its window, as the reference
              counts a dynamic-update-slice;
  collective: the `_c10d_functional` ops dispatched (and DTensor's
              `shard_dim_alltoall`), under the
              reference's wire model (`_collective_wire`: all-reduce
              2 S (g-1)/g, all-gather, reduce-scatter and all-to-all
              S (g-1)/g with S the result's bytes, a permute S), g the
              op's group's size.

Eager mode runs every iteration of a Python loop, so nothing needs a
trip count: `parse_hlo`, `_trip_count` and `_fusion_bytes` have no twin.
Eager mode also fuses nothing: every intermediate is written and read
back, so the bytes bound a fused program's from above.

The counts depend on shapes only, so a step on meta tensors counts what
the same step on real ones does. Under DTensor the mode lets DTensor
run first (a DTensor op returns NotImplemented to it) and counts the
ops that DTensor dispatches on the local shards and the collectives of
its redistributions: the numbers are one rank's. The global-shape
evaluation that DTensor's sharding propagation runs under a fake mode
is not counted. The host-transfer counter of the reference's module is
`repro_torch.obs.transfers`.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# The reference's _ARITH_1 (1 flop an output element) and _ARITH_4
# (transcendentals, 4) by aten name; an in-place variant (add_) counts
# as its op. "compare", "select" and "reduce" / "reduce-window" map to the
# comparisons, where, the reductions and the scans.
_ARITH_1 = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "clamp", "clamp_min", "clamp_max", "floor", "ceil",
    "round", "sign", "sum", "mean", "amax", "amin", "max", "min", "prod",
    "cumsum", "cumprod"}
_ARITH_4 = {"exp", "log", "rsqrt", "sqrt", "tanh", "sigmoid", "pow", "cos",
            "sin", "atan2", "expm1", "log1p", "erf"}

# In-place windowed writes: (op name, argument index of the window's data)
_WINDOWED = {"index_copy_": 3, "index_put_": 2}
# The reference's names of the collectives, by functional op
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast"}
# Functional-collective bookkeeping: no bytes of their own
_NO_BYTES = {"wait_tensor", "_wrap_tensor_autograd"}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # the port's additions: the matmul share of `flops`, the ops counted,
    # and the peak of live outputs of the counted ops (one rank's
    # temporaries: the step's inputs were allocated before it ran)
    matmul_flops: float = 0.0
    ops: int = 0
    peak_bytes: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(c["bytes"] for c in self.collectives.values())

    def add_collective(self, op: str, wire: float, mult: float):
        st = self.collectives.setdefault(op, {"count": 0, "bytes": 0.0})
        st["count"] += mult
        st["bytes"] += wire * mult


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _group_size(name) -> int:
    from torch.distributed import distributed_c10d as c10d
    group = name if isinstance(name, c10d.ProcessGroup) else \
        c10d._resolve_process_group(name)
    return group.size()


def _collective_wire(base: str, func, args, out) -> float:
    """Per-device wire bytes of one collective (the reference's model)."""
    size = sum(t.nbytes for t in _tensors(out))
    schema = [a.name for a in func._schema.arguments]
    named = dict(zip(schema, args))
    g = named.get("group_size")
    if g is None:
        g = _group_size(named["group_name"])
    if base == "all-reduce":
        return 2 * size * (g - 1) / g
    if base == "broadcast":
        return size
    return size * (g - 1) / g


def _base_name(func) -> str:
    return func._overloadpacket.__name__


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched in its block into `totals` (see the
    module's docstring); `live` follows the bytes of the counted ops'
    outputs that own new storage until they are freed."""

    def __init__(self):
        super().__init__()
        self.totals = Totals()
        self.live = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not isinstance(func, torch._ops.OpOverload):
            return func(*args, **kwargs)
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented      # count the local ops DTensor issues
        out = func(*args, **kwargs)
        if _fake_mode_active():        # DTensor's sharding propagation
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        t = self.totals
        t.ops += 1
        name = _base_name(func)
        ns = func.namespace
        outs = _tensors(out)
        if ns in ("_c10d_functional", "_dtensor"):
            if name in _COLLECTIVES:
                base = _COLLECTIVES[name]
                t.add_collective(base, _collective_wire(base, func, args,
                                                        out), 1)
            if name not in _NO_BYTES:
                self._allocated(func, outs)
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            t.flops += f
            t.matmul_flops += f
        elif name.rstrip("_") in _ARITH_1:
            t.flops += sum(o.numel() for o in outs)
        elif name.rstrip("_") in _ARITH_4:
            t.flops += 4 * sum(o.numel() for o in outs)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return                    # a view moves nothing
        if name in _WINDOWED:
            window = _tensors(args[_WINDOWED[name]] if len(args) >
                              _WINDOWED[name] else None)
            t.hbm_bytes += 2 * sum(w.nbytes for w in window)
            return
        if name.startswith("empty") or name == "new_empty":
            self._allocated(func, outs)   # storage, nothing written
            return
        if name in ("fill_", "zero_"):
            t.hbm_bytes += args[0].nbytes           # a write, no read
            return
        ins = _tensors(list(args)) + _tensors(list(kwargs.values()))
        if name != "copy_":       # copy_ reads its source, writes the view
            ins += outs
        t.hbm_bytes += sum(a.nbytes for a in ins)
        self._allocated(func, outs)

    def _allocated(self, func, outs):
        """Follow the outputs that own new storage (not views, not
        in-place results) until they are freed."""
        if any(r.alias_info is not None for r in func._schema.returns):
            return
        for o in outs:
            self.live += o.nbytes
            weakref.finalize(o, self._free, o.nbytes)
        self.totals.peak_bytes = max(self.totals.peak_bytes, self.live)


def analyze(fn, *args, **kwargs) -> Totals:
    """Totals of `fn(*args, **kwargs)`, run once under an `OpCounter`."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.totals
