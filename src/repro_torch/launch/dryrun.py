"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on meta
tensors over a fake process group of 256 or 512 ranks.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles
each cell's step (train_step with the arch's optimizer, or serve
prefill / decode) with params, optimizer state and inputs sharded by
the arch's rule set, against ShapeDtypeStruct inputs, and reads the
compiled program's memory and cost analysis. PyTorch has no compiler to
ask, so the port RUNS the step, once, on tensors that hold no data:

  - the mesh is the reference's (16, 16) ("data", "model") or (2, 16,
    16) ("pod", "data", "model") (`launch.mesh.make_production_mesh`)
    over PyTorch's fake process group, whose collectives return without
    moving anything; the group lives in this process for one cell
    (`fake_group`) and never beside CUDA work or another group;
  - parameters (`decl_shapes`), optimizer state (`opt.init` on those)
    and inputs (`Model.input_specs`) are DTensors over that mesh whose
    local tensors are meta tensors of rank 0's shard, placed by
    `make_shardings` with the arch's rule set; on a mesh of one device
    they stay plain meta tensors;
  - the step runs under `hlo_analysis.OpCounter`, which counts the ops
    that DTensor dispatches on the local shards and the collectives of
    its redistributions (`ShardCtx.constrain` among them): the FLOPs,
    bytes, collectives and the peak of live temporaries are one rank's.

Tensors that model code makes from nothing (positions, masks, loop
carries) are treated as replicated (DTensor's implicit replication),
as XLA treats an iota until it propagates a sharding to it.

The report has the reference's keys, except: `dry_run_s` (the step's
wall time under the counter) for `compile_s`; no `xla_cost_*` keys (no
XLA); `per_device.argument_bytes` is the local shard bytes of the
parameters, optimizer state and inputs, `temp_bytes` the peak of live
temporaries on one rank beyond the outputs, `output_bytes` and
`alias_bytes` the outputs and those of them updated in place (the
params and moments of a train step, a decode's cache). Eager mode fuses
nothing, so `hlo_bytes_total` bounds a fused program's bytes from above.
The roofline takes the H100 SXM's data-sheet peaks (`peaks` in the
report says which).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k --mesh multi --out out.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time

import torch

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          optimizer_for, rule_set_for)
from repro_torch.launch.hlo_analysis import OpCounter
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models.api import SHAPES, Model, ShapeSpec
from repro_torch.models.config import (RULE_SETS, make_shardings,
                                       mesh_axes, shard_ctx_for_mesh)
from repro_torch.models.layers import (decl_logical, decl_shapes, local,
                                       param_count, tree_leaves)
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.training.step import make_train_step

# H100 SXM per-device constants (NVIDIA H100 data sheet, SXM5): the
# roofline's denominators.
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s
PEAK_FP32 = 67e12        # FP32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12         # HBM3 bytes/s
LINK_BW = 450e9          # NVLink 4 bytes/s each way (900e9 both ways)
# Device memory of the H100 80GB HBM3: the bytes that
# torch.cuda.get_device_properties(0).total_memory reads on the card.
HBM_BYTES = 85_017_493_504
PEAKS_NOTE = ("H100 SXM data sheet: 989e12 bf16 dense FLOP/s, 3.35e12 "
              "HBM3 bytes/s, 450e9 NVLink bytes/s each way; the link "
              "figure holds within a node (8 cards), so across nodes "
              "collective_s is a lower bound")
BYTES_NOTE = ("eager op counts: every intermediate is written and read "
              "back, so the bytes bound a fused program's from above")


@contextlib.contextmanager
def fake_group(world: int):
    """PyTorch's fake process group of `world` ranks, this process rank 0,
    for the block's length. Refuses a process that already holds a group
    or has touched a CUDA device."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "this process already holds one")
    if torch.cuda.is_initialized():
        raise RuntimeError("the dry run's fake process group must not share "
                           "a process with CUDA work")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def active_params(model: Model) -> int:
    """6*N*D uses N_active for MoE: experts scaled by top_k/n_experts."""
    cfg = model.cfg
    total = active = 0
    for d in tree_leaves(model.decls()):
        n = math.prod(d.shape)
        total += n
        if "experts" in d.logical and cfg.n_experts:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return int(active)


def _walk(tree, other, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, o, fn) for v, o in zip(tree, other))
    return fn(tree, other)


@contextlib.contextmanager
def dtensor_on_meta():
    """Two of DTensor's CPU-side paths, for the block's length, as the
    cards would run them on meta tensors:

    - DTensor zeroes the masked rows of a vocab-sharded gather's partial
      sum by boolean indexing (``tensor[mask] = 0``), which a meta tensor
      cannot run (its index count depends on the data): `masked_fill_`
      writes the same zeros with static shapes;
    - on a CPU mesh DTensor moves a shard from one dim to another by an
      all-gather and a chunk (gloo has no all-to-all), where NCCL runs
      one all-to-all: the all-to-all op itself is issued (its meta kernel
      gives the shard's shape, and `OpCounter` counts it);
    - an uneven shard (1500 frames on 16 ranks) is padded for its
      collective and narrowed after it, which leaves a strided local
      tensor where the narrowed dim is not the first; DTensor's views
      then refuse it (on the cards too), so it is made contiguous (a
      copy, counted)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
    orig = (MaskBuffer.apply_mask, placement_types.shard_dim_alltoall,
            placement_types.unpad_tensor)

    def apply_mask(self, tensor):
        if self.refcount == 0 or self.data is None:
            raise RuntimeError("MaskBuffer has not been materialized")
        mask = self.data if tensor.ndim == self.data.ndim else \
            self.data[..., None]
        tensor.masked_fill_(mask, 0.0)

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    def unpad_tensor(tensor, pad_dim, pad_size):
        return orig[2](tensor, pad_dim, pad_size).contiguous()

    MaskBuffer.apply_mask = apply_mask
    placement_types.shard_dim_alltoall = shard_dim_alltoall
    placement_types.unpad_tensor = unpad_tensor
    try:
        yield
    finally:
        (MaskBuffer.apply_mask, placement_types.shard_dim_alltoall,
         placement_types.unpad_tensor) = orig


def on_mesh(shapes, placements, mesh):
    """The meta tensors `shapes` as DTensors over `mesh` with `placements`
    (a tree of `make_shardings`' DTensor placements), each holding a meta
    tensor of this rank's shard; the meta tensors themselves where
    `make_shardings` gave specs (a mesh of one device)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def leaf(t, pl):
        if not pl or not hasattr(pl[0], "is_shard"):
            return t
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
            run_check=False, shape=t.shape, stride=t.stride())

    return _walk(shapes, placements, leaf)


def _bytes(tensors) -> int:
    return sum(local(t).nbytes for t in tensors)


def model_flops_tokens(model: Model, shape: ShapeSpec):
    """(tokens, model FLOPs) of one step: 6 N_active D for training, 2
    N_active D for serving."""
    n_active = active_params(model)
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    per = 6 if shape.kind == "train" else 2
    return tokens, per * n_active * tokens


def step_inputs(model: Model, shape: ShapeSpec, mesh, rules, opt_name):
    """(step function, its arguments) of `shape`'s step over `mesh`."""
    ctx = shard_ctx_for_mesh(mesh)
    decls = model.decls()
    p_shapes, p_logical = decl_shapes(decls), decl_logical(decls)
    params = on_mesh(p_shapes, make_shardings(p_logical, p_shapes, rules,
                                              mesh), mesh)
    in_specs = model.input_specs(shape)
    batch = on_mesh(in_specs, make_shardings(
        model.input_logical(shape), in_specs, rules, mesh), mesh)
    if shape.kind == "train":
        opt = get_optimizer(opt_name)
        o_shapes = opt.init(p_shapes)
        state = on_mesh(o_shapes, make_shardings(
            opt.state_logical(p_logical), o_shapes, rules, mesh), mesh)
        return make_train_step(model, opt, ctx), (params, state, batch)
    if shape.kind == "prefill":
        def serve_prefill(params, batch):
            return model.prefill(params, batch, ctx, cache_len=shape.seq_len,
                                 device="meta")
        return serve_prefill, (params, batch)

    def serve_decode(params, batch):
        return model.decode(params, batch, ctx)
    return serve_decode, (params, batch)


def dry_step(model: Model, shape: ShapeSpec, mesh, rules,
             opt_name: str = "adamw") -> dict:
    """One step of `shape` for `model` over `mesh` on meta tensors, under
    an `OpCounter`: {"totals", "argument_bytes", "output_bytes",
    "alias_bytes", "seconds"}, one rank's."""
    from torch.distributed.tensor.experimental import implicit_replication
    fn, args = step_inputs(model, shape, mesh, rules, opt_name)
    arg_leaves = tree_leaves(args)
    arg_ids = {id(t) for t in arg_leaves} | {id(local(t))
                                             for t in arg_leaves}
    t0 = time.perf_counter()
    with implicit_replication(), dtensor_on_meta(), OpCounter() as counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    outs = list({id(t): t for t in tree_leaves(out)
                 if isinstance(t, torch.Tensor)}.values())
    aliased = [t for t in outs if id(t) in arg_ids or id(local(t)) in arg_ids]
    return {"totals": counter.totals, "argument_bytes": _bytes(arg_leaves),
            "output_bytes": _bytes(outs), "alias_bytes": _bytes(aliased),
            "seconds": seconds}


def cell_report(arch: str, model: Model, shape: ShapeSpec, mesh,
                mesh_name: str, check_fit: bool = True) -> dict:
    """The reference's report of one cell (see the module's docstring)."""
    rules = RULE_SETS[rule_set_for(arch)]
    step = dry_step(model, shape, mesh, rules, optimizer_for(arch))
    t = step["totals"]
    chips = math.prod(mesh_axes(mesh).values())
    tokens, model_flops = model_flops_tokens(model, shape)
    hlo_flops = t.flops * chips
    hlo_bytes = t.hbm_bytes * chips
    arg, out, alias = (step["argument_bytes"], step["output_bytes"],
                       step["alias_bytes"])
    temp = max(0, t.peak_bytes - (out - alias))
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "dry_run_s": round(step["seconds"], 1),
        "params": param_count(model.decls()),
        "active_params": active_params(model),
        "chips": chips, "tokens": tokens,
        "model_flops": model_flops,
        "hlo_flops_total": hlo_flops,
        "hlo_bytes_total": hlo_bytes,
        "matmul_flops_per_device": t.matmul_flops,
        "ops_per_device": t.ops,
        "per_device": {
            "argument_bytes": arg,
            "output_bytes": out,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_hbm_est": arg + out + temp - alias,
        },
        "collectives": t.collectives,
        "collective_wire_bytes_per_device": t.collective_bytes,
        "roofline": {
            "compute_s": hlo_flops / (chips * PEAK_FLOPS),
            "memory_s": hlo_bytes / (chips * HBM_BW),
            "collective_s": t.collective_bytes / LINK_BW,
        },
        "note": BYTES_NOTE,
    }
    r = result["roofline"]
    r["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                        key=lambda k: r[k])
    r["useful_flops_frac"] = (model_flops / hlo_flops) if hlo_flops else 0.0
    r["peaks"] = PEAKS_NOTE
    if check_fit:
        result["fits_hbm"] = bool(
            result["per_device"]["peak_hbm_est"] < HBM_BYTES)
    return result


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             check_fit: bool = True, overrides: dict = None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = Model(cfg)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not model.supports(shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": model.skip_reason(shape)}
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        return cell_report(arch, model, shape, mesh, mesh_name, check_fit)


def one_device_report(arch: str, model: Model, shape: ShapeSpec) -> dict:
    """The report of `shape`'s step on one device, as plain meta tensors
    (no process group)."""
    mesh = MeshShape((1, 1), ("data", "model"))
    return cell_report(arch, model, shape, mesh, "1x1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="")
    ap.add_argument("--override", nargs="*", default=[],
                    help="config overrides, e.g. grad_accum=4 ce_chunk=512")
    args = ap.parse_args()

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        cur = getattr(get_config(args.arch), k)
        overrides[k] = (v == "True") if isinstance(cur, bool) else type(cur)(v)
    res = run_cell(args.arch, args.shape, args.mesh == "multi",
                   overrides=overrides)
    js = json.dumps(res, indent=1)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    sys.exit(0 if res["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
