"""Dry run of the sharded treecode at the paper's scale, on meta tensors.

Port of `repro/launch/dryrun_bltc.py`. The reference lowers its
shard_map SPMD potential step for 256 ranks (one pod) or 512 (two) at
representative padded per-rank shapes (N/rank = 262,144 by default,
theta 0.8, degree 8, N_L = N_B = 4000) and reads the compiled program's
memory and roofline terms: lowering needs only shapes, so no
2-billion-particle tree is built. PyTorch has no lowering step; the
port calls its own sharded plan's `execute` and `potential_and_forces`
(`distributed.bltc.ShardedPlan`, the executor `sharded_sweep`) for ONE
rank, on a plan whose arrays are ``torch.device("meta")`` tensors of the
reference's table's sizes, with the all-gathers and the halo rounds as
shape operations (`MetaRanks`). Nothing is allocated and no kernel is
launched: each kernel entry the executor reaches (`kernels/ops.py`:
the ranged modified charges and the three batch-cluster entries)
returns an empty meta tensor of the shape the kernel writes, so the
step follows the kernel path's allocations, not the plain versions'
(whose (B, NB, S, m) intermediates the card never builds). A dispatch
mode tallies the bytes: the rank's arguments, the peak of live outputs,
the bytes every op reads and writes. A host pull anywhere on that path
fails loudly, since ``.item()`` on a meta tensor raises: a second,
dynamic check of the lint over the sharded executor.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_bltc [--multi]
      [--n-per-rank 262144] [--out PATH]

The FLOP and bytes terms are taken against the H100 SXM's published
peaks (NVIDIA data sheet; the constants `chip_smoke.py` bounds its
kernels with). There is no collective time: no link was measured.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import eval as ceval
from repro_torch.core.api import TreecodeConfig, lift_params
from repro_torch.distributed import bltc
from repro_torch.kernels import modified_charges as _mc

# H100 SXM published peaks (NVIDIA data sheet), as in `chip_smoke.py`.
PEAK_FP32 = 67e12      # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes/s
# Operations per (target, source) pair of the batch-cluster sum:
# 3 sub + 3 mul + 2 add (r^2), sqrt, divide, multiply by q, add.
FLOPS_PER_PAIR = 12

META = torch.device("meta")


def synthetic_shapes(nranks: int, n_per_rank: int, cfg: TreecodeConfig):
    """Representative padded per-rank tables for a uniform distribution,
    stacked over the ranks, as meta tensors: the reference's (shape,
    dtype) table. Returns (tensors by name, dict(depth, rounds, k3))."""
    leaf = cfg.leaf_size
    n1 = cfg.degree + 1
    k3 = n1 ** 3
    nleaves = max(2, int(1.3 * n_per_rank / leaf))
    nnodes = 2 * nleaves + 1
    nbatches = nleaves
    # uniform-cube interaction list widths (the reference's: ~40 approx
    # + ~30 direct per batch at theta 0.8)
    a_pad, d_pad = 48, 32
    depth = int(math.ceil(math.log2(max(nleaves, 2)) / 3)) + 2
    f32, i32 = torch.float32, torch.int32
    shapes = dict(
        src_sorted=((nranks, n_per_rank, 3), f32),
        charges_perm=((nranks, n_per_rank), i32),
        tgt_batched=((nranks, nbatches, leaf, 3), f32),
        gather_index=((nranks, n_per_rank), i32),
        leaf_gather=((nranks, nleaves, leaf), i32),
        node_lo=((nranks, nnodes, 3), f32),
        node_hi=((nranks, nnodes, 3), f32),
        approx_idx=((nranks, nbatches, a_pad), i32),
        direct_idx=((nranks, nbatches, d_pad), i32),
        remote_approx_idx=((nranks, nbatches, 24), i32),
        remote_direct_idx=((nranks, nbatches, 16), i32),
    )
    # per-level buckets: geometric sizes down the tree
    c = 1
    for lvl in range(depth):
        m = min(n_per_rank, max(leaf, n_per_rank // max(c, 1)))
        shapes[f"bucket_gather_{lvl}"] = ((nranks, c, m), i32)
        shapes[f"bucket_nodes_{lvl}"] = ((nranks, c), i32)
        c = min(nnodes, c * 8)
    # two halo rounds (+-1 neighbor), 8 boundary leaves each
    shapes["halo_send_0"] = ((nranks, 8), i32)
    shapes["halo_send_1"] = ((nranks, 8), i32)
    tensors = {k: torch.empty(s, dtype=d, device=META)
               for k, (s, d) in shapes.items()}
    return tensors, dict(depth=depth, rounds=2, k3=k3)


class ByteTally(TorchDispatchMode):
    """Bytes of the ops dispatched in its block: `moved` counts every
    op's tensor inputs and outputs once each; `live` / `peak` follow the
    outputs that own new storage (views are not allocations) until they
    are freed."""

    def __init__(self):
        super().__init__()
        self.moved = 0
        self.live = 0
        self.peak = 0
        self.ops = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        flat = out if isinstance(out, (tuple, list)) else (out,)
        views = any(r.alias_info is not None for r in func._schema.returns)
        for a in list(args) + list((kwargs or {}).values()):
            if isinstance(a, torch.Tensor):
                self.moved += a.nbytes
        for t in flat:
            if isinstance(t, torch.Tensor) and not views:
                self.moved += t.nbytes
                self.live += t.nbytes
                weakref.finalize(t, self._free, t.nbytes)
        self.peak = max(self.peak, self.live)
        return out


class MetaRanks:
    """One rank of P on the meta device, behind the two collectives of
    `distributed.exchange` that the sharded executor calls: R = 1 local
    rank, as a `GroupRanks` process holds, and every collective a shape
    operation that counts the bytes this rank receives (an all-gather
    brings P - 1 remote copies, a halo round one neighbour's buffer)."""

    def __init__(self, nranks: int):
        self.nranks = int(nranks)
        self.stats = {}

    def _count(self, kind: str, nbytes: int) -> None:
        st = self.stats.setdefault(kind, {"count": 0, "bytes": 0})
        st["count"] += 1
        st["bytes"] += nbytes

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self._count("all-gather", (self.nranks - 1) * t.nbytes)
        return t.new_empty((self.nranks * t.shape[0],) + tuple(t.shape[1:]))

    def halo_round(self, tensors, off: int) -> list:
        for t in tensors:
            self._count("collective-permute", t.nbytes)
        return [t.new_empty(t.shape) for t in tensors]


def meta_plan(nranks: int, n_per_rank: int, cfg: TreecodeConfig):
    """A `ShardedPlan` for one rank of `nranks` whose arrays are meta
    tensors of `synthetic_shapes`' sizes, in the port's layout: the
    reference's tables (this rank's row), int32 where the kernels read
    them (`bltc._INT32_KEYS`) and int64 for the gathers, with the target
    mask and the modified charges' chunk table (every bucket row cut into
    `CHUNK`-point chunks) in place of the per-level buckets. The fields
    the device execution reads are real; the host-side ones (the RCB cut
    and the per-rank budget) are None, as no tree is built. Returns
    (plan, dict(depth, rounds, k3), the reference's tables)."""
    tables, meta = synthetic_shapes(nranks, n_per_rank, cfg)
    arrays = {}
    for k, v in tables.items():
        if k.startswith("bucket_"):
            continue
        if not v.dtype.is_floating_point:
            v = v.to(torch.int32 if k in bltc._INT32_KEYS else torch.int64)
        arrays[k] = v[:1]
    nb = tables["tgt_batched"].shape[1:3]
    nnodes = tables["node_lo"].shape[1]
    nchunks = sum(tables[f"bucket_gather_{lvl}"].shape[1]
                  * -(-tables[f"bucket_gather_{lvl}"].shape[2] // _mc.CHUNK)
                  for lvl in range(meta["depth"]))
    arrays["tgt_mask"] = torch.empty((1,) + nb, dtype=torch.bool,
                                     device=META)
    arrays["mc_chunks"] = torch.empty((1, nchunks, 3), dtype=torch.int32,
                                      device=META)
    arrays["mc_chunk_ptr"] = torch.empty((1, nnodes + 1), dtype=torch.int32,
                                         device=META)
    kernel = cfg.make_kernel()
    n = nranks * n_per_rank
    caps = ceval.ShardedCapacities(
        rank=None, nranks=nranks, slab_width=n_per_rank,
        remote_approx_width=tables["remote_approx_idx"].shape[2],
        remote_direct_width=tables["remote_direct_idx"].shape[2],
        halo_offsets=ceval.ShardedCapacities._offset_range([1]),
        halo_width=tables["halo_send_0"].shape[1])
    plan = bltc.ShardedPlan(
        config=cfg, kernel=kernel, arrays=arrays, perm_rounds=(),
        depth=meta["depth"], nranks=nranks, rcb=None, scratch_node=-1,
        per_pad=n_per_rank, num_points=n, padding_waste=0.0,
        dtype=torch.float32, ranks=MetaRanks(nranks), capacities=caps,
        rank_gather=torch.empty((1, n_per_rank), dtype=torch.int64,
                                device=META),
        input_pos=torch.empty((n,), dtype=torch.int64, device=META),
        kernel_params=lift_params(kernel, torch.float32, META))
    return plan, meta, tables


def model_interactions_per_rank(tables: dict, cfg: TreecodeConfig,
                                k3: int) -> int:
    """The reference's count: every approx slot of every batch against a
    Chebyshev grid, every direct slot against a full leaf."""
    ap, dr = tables["approx_idx"].shape, tables["direct_idx"].shape
    nb = cfg.resolved_batch_size()
    return ap[1] * ap[2] * nb * k3 + dr[1] * dr[2] * nb * cfg.leaf_size


def _step(fn, plan) -> dict:
    """`fn()` under a fresh `ByteTally` and collective count: its output
    shape, the peak of live outputs, the bytes read and written, the ops
    and the collectives."""
    plan.ranks.stats = {}
    tally = ByteTally()
    with tally:
        out = fn()
    coll = plan.ranks.stats
    return {"shape": [list(o.shape) for o in out] if isinstance(out, tuple)
            else list(out.shape),
            "peak_live_output_bytes": tally.peak, "bytes": tally.moved,
            "ops": tally.ops, "collectives": coll,
            "collective_bytes": sum(c["bytes"] for c in coll.values())}


def dry_run(nranks: int, n_per_rank: int, multi: bool = False) -> dict:
    """The sharded plan's `execute` and `potential_and_forces` for one rank
    of `nranks` (n_per_rank points each) on meta tensors (`multi`: the
    mesh is two pods of nranks / 2). Returns the report of the potential
    step, with the force step's under "forces"; `phi_shape` is the
    execute's output, every rank's potentials in input order."""
    cfg = TreecodeConfig(theta=0.8, degree=8, leaf_size=4000,
                         batch_size=4000)
    plan, meta, tables = meta_plan(nranks, n_per_rank, cfg)
    q = torch.empty((plan.num_points,), dtype=torch.float32, device=META)
    t0 = time.perf_counter()
    pot = _step(lambda: plan.execute(q), plan)
    forces = _step(lambda: plan.potential_and_forces(q), plan)
    wall_s = time.perf_counter() - t0
    interactions = model_interactions_per_rank(tables, cfg, meta["k3"])
    flops = interactions * FLOPS_PER_PAIR
    plan_bytes = sum(v.nbytes for v in plan.arrays.values()) \
        + plan.rank_gather.nbytes
    replicated = plan.input_pos.nbytes + q.nbytes
    return {
        "mesh": f"2x{nranks // 2}" if multi else f"{nranks}",
        "status": "ok",
        "dry_run_s": wall_s,
        "phi_shape": pot["shape"],
        "per_rank": {"argument_bytes": plan_bytes + replicated,
                     "replicated_input_bytes": replicated,
                     "peak_live_output_bytes": pot["peak_live_output_bytes"],
                     "ops": pot["ops"]},
        "flops_per_rank": flops,
        "bytes_per_rank": pot["bytes"],
        "collectives": pot["collectives"],
        "collective_bytes_per_rank": pot["collective_bytes"],
        "roofline": {
            "compute_s": flops / PEAK_FP32,
            "memory_s": pot["bytes"] / PEAK_BYTES,
            "peaks": "H100 SXM data sheet: 67e12 FP32 FLOP/s, 3.35e12 "
                     "HBM3 bytes/s; no link measured, so no "
                     "collective time",
        },
        "model_interactions_per_rank": interactions,
        "forces": forces,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--n-per-rank", type=int, default=262144)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    nranks = 512 if args.multi else 256
    res = dry_run(nranks, args.n_per_rank, args.multi)
    js = json.dumps(res, indent=1, default=float)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
