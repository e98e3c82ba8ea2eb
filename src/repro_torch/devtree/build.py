"""Adaptive-depth budgeted octree from Morton codes, on the device.

Port of `repro/devtree/build.py`. The host build is a recursive midpoint
bisection; the device build is the standard GPU alternative (Gaburov &
Bedorf, arXiv:1005.5384): a HYBRID octree over the Morton grid, a dense
complete octree through a static split depth, then one COMPACTED
occupied-cell block per deeper level. A cell at level l is a 3l-bit code
prefix, so after the radix sort every cell owns a contiguous particle
run found with one segmented reduction; no recursion and no
data-dependent shapes:

  * dense levels (l <= `SPLIT_DEPTH`): counts from the sorted-run
    boundaries (one `searchsorted` over the code prefix), coarser levels
    by (cells/8, 8) reshape reductions, gid = OFF[l] + cell;
  * sparse levels (l > `SPLIT_DEPTH`): the occupied cells come from
    boundary-mask compaction of the sorted prefixes (cumsum +
    searchsorted, as in `lists.py`) into a `Capacities.sparse_rows`-
    budgeted table sorted by code; gid = block_base + row;
  * boxes: one `scatter_reduce` min/max at the deepest level, then exact
    upward aggregation (parents gather their children's code window);
  * occupancy: a cell is ACTIVE if non-empty with an active internal
    parent; an active cell is a LEAF if its count fits `leaf_size` or it
    sits at the bottom level;
  * leaves and batches are enumerated into budgeted tables by a stable
    sort on start (leaf slots in particle order, as on the host), and
    every structure is padded to a `Capacities` budget with the
    conventions of `eval.pad_plan` (-1 gathers, [0, 1] boxes, scratch
    node ids).

The plan has the `arrays` schema of the host `eval.prepare_plan`, the
modified charges' chunk table included (built here from the active
nodes' ranges), plus `plan.dev` metadata behind lazy host `Tree` /
`Batches` proxies, which diagnostics build on first touch and the MD
step loop never touches. A budgeted rebuild reads back only the needs
vector (a few dozen integers) and the two slacks, in one transfer.

Every float reduction is a min or a max and every sum an integer one,
so a build on the card is bitwise reproducible.

`dispatch_plan_device` is the double-buffered variant of that rebuild:
on CUDA it enqueues the sort, build and list passes on a side stream
(which first waits for the current one) and returns a
`PendingDevicePlan` without reading anything back, so the caller keeps
launching work on its live plan while the shadow build runs;
`finalize()` waits for an event recorded behind the build and pays only
what is left.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core import eval as _eval
from repro_torch.core import interaction as _interaction
from repro_torch.core.space import FREE as _FREE
from repro_torch.core.tree import Batches, Tree
from repro_torch.devtree import lists as _lists
from repro_torch.devtree import morton as _morton
from repro_torch.kernels.modified_charges import CHUNK
from repro_torch.lint import runtime as _rt
from repro_torch.obs import events as _events
from repro_torch.obs import trace as _trace

#: Deepest level stored DENSELY: (8^(S+1) - 1)/7 = 4681 rows at S = 4,
#: and the modified-charge table is O(num_nodes (n+1)^3); deeper levels
#: switch to compacted occupied-cell blocks whose size tracks the data.
SPLIT_DEPTH = 4

#: Adaptive-depth cap. Morton codes carry 3 * BITS = 30 bits, so 8
#: levels (24 bits) leave slack.
MAX_DEPTH = 8

_I32 = torch.int32
_I32MAX = 2 ** 31 - 1
_INF = float("inf")


def depth_for(n: int, leaf_size: int, max_depth: int = MAX_DEPTH) -> int:
    """Smallest depth whose 8^d cells could hold n at leaf_size, capped."""
    d = 1
    while (8 ** d) * max(leaf_size, 1) < n and d < max_depth:
        d += 1
    return d


@functools.lru_cache(maxsize=None)
def _static_nodes(depth: int):
    """(offsets, M, level_of, parent_of) of the dense block, in NumPy
    (the host proxies read them)."""
    off = tuple((8 ** l - 1) // 7 for l in range(depth + 2))
    m = off[depth + 1]
    level = np.concatenate(
        [np.full(8 ** l, l, np.int32) for l in range(depth + 1)])
    parent = np.full(m, -1, np.int32)
    for l in range(1, depth + 1):
        k = np.arange(8 ** l, dtype=np.int32)
        parent[off[l] + k] = off[l - 1] + (k >> 3)
    return off, m, level, parent


@functools.lru_cache(maxsize=None)
def _level_spans(depth: int, srows):
    """Static ((base, length) per level, total rows) of the hybrid
    node-id space: dense levels first (gid = OFF[l] + cell), then one
    budgeted block per sparse level (gid = base + occupied row)."""
    sd = min(depth, SPLIT_DEPTH)
    off, m, _, _ = _static_nodes(sd)
    spans = [(off[l], 8 ** l) for l in range(sd + 1)]
    base = m
    for r in srows:
        spans.append((base, r))
        base += r
    return tuple(spans), base


def _clamp_nodes(caps: "_eval.Capacities", depth: int):
    """Grow `num_nodes` to cover the hybrid layout its sparse row
    budgets imply (+1 scratch row)."""
    _, m_tot = _level_spans(depth, caps.sparse_rows)
    if caps.num_nodes < m_tot + 1:
        caps = dataclasses.replace(caps, num_nodes=m_tot + 1)
    return caps


def _arange(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=_I32, device=device)


def _search(seq, values, right: bool = False):
    return torch.searchsorted(seq, values, out_int32=True, right=right)


def _segment(x: torch.Tensor, seg: torch.Tensor, nseg: int,
             reduce: str) -> torch.Tensor:
    """Per-segment min or max of the rows of `x` (N, 3); an empty
    segment keeps the reduction's identity (+inf for min, -inf for max).
    Min and max do not depend on the order of the atomics."""
    fill = _INF if reduce == "amin" else -_INF
    out = x.new_full((nseg, x.shape[1]), fill)
    idx = seg.long()[:, None].expand(-1, x.shape[1])
    # lint: disable=DV001 — replan-time segmented min/max (the reference's
    # `jax.ops.segment_min`); the scatter-free contract covers the
    # per-step traversal, which stays gather-only.
    return out.scatter_reduce_(0, idx, x, reduce, include_self=True)


def _repeat8(v: torch.Tensor) -> torch.Tensor:
    """Each entry 8 times (`repeat_interleave` by a constant, without
    asking the device for the output size)."""
    return v[:, None].expand(-1, 8).reshape(-1)


def _dense_levels(x_sorted, codes, *, depth, leaf_size, bits,
                  bottom_leaf=True, bottom_boxes=None):
    """Dense per-cell tensors for levels 0..depth, as per-level lists.

    Bottom counts come from the sorted-run boundaries (one
    `searchsorted` over the code prefix); every coarser level aggregates
    its children with a (cells/8, 8) reshape reduction, exact because a
    parent's particle run is the concatenation of its children's. The
    segmented box reduction runs once, at the deepest level, unless a
    hybrid build injects `bottom_boxes` aggregated from its sparse
    levels (empty cells carry the +/-inf identities there). With
    ``bottom_leaf=False`` the bottom level keeps only the count-based
    leaf rule, so oversized bottom cells stay internal and the activity
    chain continues into the sparse levels (returned as the bottom
    `parent_internal` mask).
    """
    dev = codes.device
    nseg = 8 ** depth
    seg = _morton.prefix(codes, depth, bits)
    bounds = _search(seg, _arange(nseg + 1, dev))
    cnt = bounds[1:] - bounds[:-1]
    start = bounds[:-1]
    if bottom_boxes is None:
        lo = _segment(x_sorted, seg, nseg, "amin")
        hi = _segment(x_sorted, seg, nseg, "amax")
    else:
        lo, hi = bottom_boxes
    per = {depth: (cnt, start, lo, hi)}
    for l in range(depth - 1, -1, -1):
        cnt = cnt.reshape(-1, 8).sum(1, dtype=_I32)
        start = start.reshape(-1, 8)[:, 0]
        lo = lo.reshape(-1, 8, 3).amin(1)
        hi = hi.reshape(-1, 8, 3).amax(1)
        per[l] = (cnt, start, lo, hi)
    out = {k: [] for k in ("count", "start", "lo", "hi", "active", "leaf")}
    parent_internal = None
    for l in range(depth + 1):
        cnt, start, lo, hi = per[l]
        nonempty = cnt > 0
        # Empty cells keep the [0, 1] sentinel box (pad_plan convention).
        lo = torch.where(nonempty[:, None], lo, 0.0)
        hi = torch.where(nonempty[:, None], hi, 1.0)
        act = nonempty if l == 0 else nonempty & _repeat8(parent_internal)
        leaf = act & (cnt <= leaf_size)
        if bottom_leaf and l == depth:
            leaf = act
        parent_internal = act & ~leaf
        for k, v in zip(("count", "start", "lo", "hi", "active", "leaf"),
                        (cnt, start, lo, hi, act, leaf)):
            out[k].append(v)
    return out, parent_internal


def _child_boxes(par_code, kid_code, kid_lo, kid_hi):
    """Aggregate child boxes into parents by sorted-window gather: a
    parent's occupied children sit contiguously in the ascending child
    code table, at [searchsorted(kids, p*8), searchsorted(kids, p*8+8)).
    Childless parents come out at the +/-inf reduction identities."""
    r = kid_code.shape[0]
    clo = _search(kid_code, par_code * 8)
    chi = _search(kid_code, par_code * 8 + 8)
    k8 = _arange(8, kid_code.device)[None, :]
    idx = (clo[:, None] + k8).clamp(0, r - 1)
    has = (k8 < (chi - clo)[:, None])[..., None]
    lo = torch.where(has, kid_lo[idx], _INF).amin(1)
    hi = torch.where(has, kid_hi[idx], -_INF).amax(1)
    return lo, hi


def _hybrid_structs(x_sorted, codes, *, depth, rows, leaf_size, bits):
    """Flat per-node tensors over the hybrid node-id space.

    Returns (st, node_code, n_occ): `st` holds the per-node struct keys
    concatenated over dense-then-sparse blocks, `node_code` is every
    row's cell code at its own level (`PAD_CODE` on padded sparse rows),
    and `n_occ` the TRUE per-sparse-level occupied-cell counts: the
    needs-vector entries that detect a row-budget overflow (truncated
    tables are then garbage, discarded by the growth loop).
    """
    dev = codes.device
    sd = min(depth, SPLIT_DEPTH)
    n = x_sorted.shape[0]
    if depth <= sd:
        out, _ = _dense_levels(x_sorted, codes, depth=depth,
                               leaf_size=leaf_size, bits=bits)
        st = {k: torch.cat(v, 0) for k, v in out.items()}
        node_code = torch.cat([_arange(8 ** l, dev)
                               for l in range(depth + 1)])
        return st, node_code, ()

    assert len(rows) == depth - sd
    # Occupied-cell discovery per sparse level: boundary-mask compaction
    # of the sorted prefixes. A padded row gets start = n (so its count
    # is 0) and code = PAD_CODE; the last real row's count runs to the
    # next row's start, which is n at the end.
    lvls, occs = [], []
    for i, l in enumerate(range(sd + 1, depth + 1)):
        r = rows[i]
        seg = _morton.prefix(codes, l, bits)
        first = torch.ones_like(seg, dtype=torch.bool)
        first[1:] = seg[1:] != seg[:-1]
        c = torch.cumsum(first.to(_I32), 0, dtype=_I32)
        want = _arange(r, dev, start=1)
        idx = _search(c, want).clamp(0, n - 1)
        ok = want <= c[-1]
        start = torch.where(ok, idx, n)
        code = torch.where(ok, seg[idx], _morton.PAD_CODE)
        nxt = torch.cat([start[1:], torch.full((1,), n, dtype=_I32,
                                               device=dev)])
        lvls.append(dict(code=code, start=start, count=nxt - start, ok=ok))
        occs.append(c[-1])

    # Boxes: one segmented reduction at the deepest level (row ids are
    # nondecreasing along the sorted particles), aggregated upward
    # through the code windows, then injected into the dense block.
    deep, rdeep = lvls[-1], rows[-1]
    row_of = _search(deep["code"], _morton.prefix(codes, depth, bits)
                     ).clamp(0, rdeep - 1)
    deep["lo"] = _segment(x_sorted, row_of, rdeep, "amin")
    deep["hi"] = _segment(x_sorted, row_of, rdeep, "amax")
    for i in range(len(lvls) - 2, -1, -1):
        lvls[i]["lo"], lvls[i]["hi"] = _child_boxes(
            lvls[i]["code"], lvls[i + 1]["code"],
            lvls[i + 1]["lo"], lvls[i + 1]["hi"])
    dlo, dhi = _child_boxes(_arange(8 ** sd, dev), lvls[0]["code"],
                            lvls[0]["lo"], lvls[0]["hi"])
    out, par_int = _dense_levels(x_sorted, codes, depth=sd,
                                 leaf_size=leaf_size, bits=bits,
                                 bottom_leaf=False, bottom_boxes=(dlo, dhi))

    # The active/leaf chain continues top-down through the sparse levels:
    # a row's parent is a dense-bottom cell (block 0, bit arithmetic) or
    # the previous block's row holding code >> 3 (searchsorted, with a
    # code-match guard so padded rows never borrow a parent).
    parts = {k: list(v) for k, v in out.items()}
    code_parts = [_arange(8 ** l, dev) for l in range(sd + 1)]
    prev = None
    for i, l in enumerate(range(sd + 1, depth + 1)):
        d = lvls[i]
        pc = d["code"] >> 3
        if prev is None:
            par_internal = par_int[pc.clamp(0, 8 ** sd - 1)]
        else:
            pr = _search(prev["code"], pc).clamp(0, rows[i - 1] - 1)
            par_internal = prev["internal"][pr] & (prev["code"][pr] == pc)
        act = d["ok"] & par_internal
        leaf = act & ((d["count"] <= leaf_size) | (l == depth))
        d["internal"] = act & ~leaf
        parts["count"].append(torch.where(d["ok"], d["count"], 0))
        parts["start"].append(d["start"])
        parts["lo"].append(torch.where(d["ok"][:, None], d["lo"], 0.0))
        parts["hi"].append(torch.where(d["ok"][:, None], d["hi"], 1.0))
        parts["active"].append(act)
        parts["leaf"].append(leaf)
        code_parts.append(d["code"])
        prev = d
    st = {k: torch.cat(v, 0) for k, v in parts.items()}
    return st, torch.cat(code_parts), tuple(occs)


def _leaf_tables(st, *, cap, width):
    """Budgeted enumeration of the leaf cells of a level structure.

    Rows are in particle (start) order, the host `Tree.leaf_ids`
    convention, so leaf particle ranges tile [0, N) across valid rows.
    Serves both the source leaves and (applied to the target tree) the
    batches. Rows past the true leaf count are sentinel rows.
    """
    dev = st["count"].device
    m = st["count"].shape[0]
    n = st["leaf"].sum(dtype=_I32)
    key = torch.where(st["leaf"], st["start"], _I32MAX)
    order = torch.sort(key, stable=True)[1].to(_I32)
    idx = _arange(cap, dev)
    ids = order[idx.clamp(0, m - 1)]
    valid = (idx < m) & (idx < n)
    start = torch.where(valid, st["start"][ids], 0)
    count = torch.where(valid, st["count"][ids], 0)
    ar = _arange(width, dev)
    gather = torch.where(ar[None, :] < count[:, None],
                         start[:, None] + ar[None, :], -1)
    return dict(
        ids=torch.where(valid, ids, -1), n=n, valid=valid,
        start=start, count=count, gather=gather,
        lo=torch.where(valid[:, None], st["lo"][ids], 0.0),
        hi=torch.where(valid[:, None], st["hi"][ids], 1.0),
        max_count=torch.where(st["leaf"], st["count"], 0).amax(),
    )


def _bucket_tables(st, *, spans, rows, widths, scratch):
    """Per-level active-node gather tables (the plan's bucket arrays)."""
    dev = st["count"].device
    gathers, nodes = [], []
    for (base, ln), rcap, w in zip(spans, rows, widths):
        act = st["active"][base:base + ln]
        n_act = act.sum(dtype=_I32)
        order = torch.sort((~act).to(_I32), stable=True)[1].to(_I32)
        idx = _arange(rcap, dev)
        cells = order[idx.clamp(0, ln - 1)]
        valid = (idx < ln) & (idx < n_act)
        start = torch.where(valid, st["start"][base + cells], 0)
        count = torch.where(valid, st["count"][base + cells], 0)
        ar = _arange(w, dev)
        gathers.append(torch.where(ar[None, :] < count[:, None],
                                   start[:, None] + ar[None, :], -1))
        nodes.append(torch.where(valid, base + cells, scratch))
    return tuple(gathers), tuple(nodes)


def _chunk_table(start, count, active, *, num_nodes, rows, scratch):
    """The modified charges' chunk table of the active nodes' particle
    ranges (`modified_charges.chunk_table`'s layout, padded as
    `eval.pad_plan` pads it): chunks (rows, 3) int32 (node, begin, end)
    of at most CHUNK particles, chunk_ptr (num_nodes + 1,). Row r belongs
    to the node whose pointer range holds r (one searchsorted), so no
    count leaves the device; the true chunk count is the need."""
    dev = start.device
    m = start.shape[0]
    cnt = torch.zeros((num_nodes,), dtype=_I32, device=dev)
    cnt[:m] = torch.where(active, count, 0)
    beg = torch.zeros((num_nodes,), dtype=_I32, device=dev)
    beg[:m] = start
    per = (cnt + (CHUNK - 1)) // CHUNK
    ptr = torch.cat([torch.zeros((1,), dtype=_I32, device=dev),
                     torch.cumsum(per, 0, dtype=_I32)])
    r = _arange(rows, dev)
    node = _search(ptr[1:], r, right=True).clamp(0, num_nodes - 1)
    ok = r < ptr[-1]
    first = beg[node] + (r - ptr[node]) * CHUNK
    end = torch.minimum(first + CHUNK, beg[node] + cnt[node])
    chunks = torch.stack([torch.where(ok, node, scratch),
                          torch.where(ok, first, 0),
                          torch.where(ok, end, 0)], dim=1)
    return chunks, ptr, ptr[-1]


def _chunk_need(st) -> torch.Tensor:
    """Rows of the active nodes' chunk table (0-d)."""
    cnt = torch.where(st["active"], st["count"], 0)
    return ((cnt + (CHUNK - 1)) // CHUNK).sum(dtype=_I32)


def _dense_parents(sd: int, device) -> torch.Tensor:
    """The dense block's parent table, built on the device (root -1)."""
    off = _static_nodes(sd)[0]
    parts = [torch.full((1,), -1, dtype=_I32, device=device)]
    for l in range(1, sd + 1):
        parts.append(off[l - 1] + (_arange(8 ** l, device) >> 3))
    return torch.cat(parts)


def _build_dims(caps: "_eval.Capacities"):
    """The part of the budget the build phase's shapes depend on (list
    lane widths excluded)."""
    return (caps.num_leaves, caps.leaf_width, caps.num_batches,
            caps.batch_width, caps.num_nodes, caps.scratch_node,
            caps.bucket_rows, caps.bucket_widths, caps.num_chunks,
            caps.sparse_rows, caps.batch_sparse_rows)


def _build_phase(xs_sorted, codes_s, xt_sorted, codes_t, order_t, *,
                 dims, depth, tdepth, leaf_size, batch_size, bits):
    """Sorted particles -> budgeted tree/batch/pack tensors."""
    (n_leaf_cap, leaf_w, n_batch_cap, batch_w, num_nodes, scratch,
     bucket_rows, bucket_widths, num_chunks, srows, tsrows) = dims
    dev = codes_s.device
    sd = min(depth, SPLIT_DEPTH)
    off = _static_nodes(sd)[0]
    spans, m = _level_spans(depth, srows)

    ss, scode, socc = _hybrid_structs(
        xs_sorted, codes_s, depth=depth, rows=srows,
        leaf_size=leaf_size, bits=bits)
    tt, _, tocc = _hybrid_structs(
        xt_sorted, codes_t, depth=tdepth, rows=tsrows,
        leaf_size=batch_size, bits=bits)
    leaf = _leaf_tables(ss, cap=n_leaf_cap, width=leaf_w)
    batch = _leaf_tables(tt, cap=n_batch_cap, width=batch_w)

    # Target slab packing and the input-order gather (the host pack's
    # device analogue): scatter each sorted target's padded slot, then
    # compose with the inverse sort permutation. Each real slot is
    # written once; out-of-budget entries land in a dropped row. These
    # are replan-time scatters, as in the reference; the per-step
    # traversal stays gather-only.
    n_t = xt_sorted.shape[0]
    g = batch["gather"]
    mask = g >= 0
    tgt_b = torch.where(mask[..., None], xt_sorted[g.clamp(0, n_t - 1)],
                        0.0)
    slots = _arange(g.numel(), dev)
    pos_sorted = torch.zeros((n_t + 1,), dtype=_I32, device=dev).scatter_(
        0, torch.where(mask, g, n_t).reshape(-1).long(), slots)[:n_t]
    inv_t = torch.empty((n_t,), dtype=_I32, device=dev).scatter_(
        0, order_t, _arange(n_t, dev))
    gather_index = pos_sorted[inv_t]

    bucket_gather, bucket_nodes = _bucket_tables(
        ss, spans=spans, rows=bucket_rows, widths=bucket_widths,
        scratch=scratch)

    dt = xs_sorted.dtype
    node_lo = torch.zeros((num_nodes, 3), dtype=dt, device=dev)
    node_lo[:m] = ss["lo"]
    node_hi = torch.ones((num_nodes, 3), dtype=dt, device=dev)
    node_hi[:m] = ss["hi"]

    # Hybrid parent table: dense parents are static, block 0's parents
    # are dense-bottom bit arithmetic, deeper blocks find code >> 3 in
    # the previous block. Padded rows park on scratch.
    pparts = [_dense_parents(sd, dev)]
    for i, (base, r) in enumerate(spans[sd + 1:]):
        code = scode[base:base + r]
        pc = code >> 3
        if i == 0:
            par = off[sd] + pc.clamp(0, 8 ** sd - 1)
        else:
            pbase, pr = spans[sd + i]
            pcode = scode[pbase:pbase + pr]
            par = pbase + _search(pcode, pc).clamp(0, pr - 1)
        pparts.append(torch.where(code < _morton.PAD_CODE, par, scratch))
    parent_of = torch.full((num_nodes,), scratch, dtype=_I32, device=dev)
    parent_of[:m] = torch.cat(pparts)

    mc_chunks, mc_chunk_ptr, n_chunks = _chunk_table(
        ss["start"], ss["count"], ss["active"], num_nodes=num_nodes,
        rows=num_chunks, scratch=scratch)

    busy_rows, busy_widths = [], []
    for base, ln in spans:
        act = ss["active"][base:base + ln]
        busy_rows.append(act.sum(dtype=_I32))
        busy_widths.append(torch.where(
            act, ss["count"][base:base + ln], 0).amax())

    return dict(
        node_count=ss["count"], node_start=ss["start"],
        node_active=ss["active"], node_leaf=ss["leaf"],
        node_lo=node_lo, node_hi=node_hi, node_code=scode,
        parent_of=parent_of,
        leaf=leaf, batch=batch,
        tgt_batched=tgt_b, tgt_mask=mask, gather_index=gather_index,
        bucket_gather=bucket_gather, bucket_nodes=bucket_nodes,
        mc_chunks=mc_chunks, mc_chunk_ptr=mc_chunk_ptr,
        need=dict(num_leaves=leaf["n"], leaf_width=leaf["max_count"],
                  num_batches=batch["n"], batch_width=batch["max_count"],
                  bucket_rows=tuple(busy_rows),
                  bucket_widths=tuple(busy_widths),
                  num_chunks=n_chunks,
                  sparse_rows=socc, batch_sparse_rows=tocc),
    )


def _occupancy_phase(codes_s, codes_t, *, depth, tdepth, bits):
    """Stage-0 probe: per-sparse-level occupied-cell counts for both
    trees, as 0-d boundary-mask sums."""

    def occ(codes, d):
        res = []
        for l in range(min(d, SPLIT_DEPTH) + 1, d + 1):
            seg = _morton.prefix(codes, l, bits)
            res.append(1 + (seg[1:] != seg[:-1]).sum(dtype=_I32))
        return tuple(res)

    return occ(codes_s, depth), occ(codes_t, tdepth)


def _needs_phase(xs_sorted, codes_s, xt_sorted, codes_t, *,
                 depth, tdepth, leaf_size, batch_size, bits,
                 srows, tsrows):
    """First-build probe: the structural needs, 1-D reductions only.

    Runs before the full budget exists; the sparse row budgets come from
    the stage-0 occupancy probe, so nothing here is sized by a guess
    that could truncate. Every output is 0-d."""
    ss, _, socc = _hybrid_structs(xs_sorted, codes_s, depth=depth,
                                  rows=srows, leaf_size=leaf_size,
                                  bits=bits)
    tt, _, tocc = _hybrid_structs(xt_sorted, codes_t, depth=tdepth,
                                  rows=tsrows, leaf_size=batch_size,
                                  bits=bits)
    spans, _ = _level_spans(depth, srows)
    rows, widths = [], []
    for base, ln in spans:
        act = ss["active"][base:base + ln]
        rows.append(act.sum(dtype=_I32))
        widths.append(torch.where(act, ss["count"][base:base + ln],
                                  0).amax())
    return dict(
        num_leaves=ss["leaf"].sum(dtype=_I32),
        leaf_width=torch.where(ss["leaf"], ss["count"], 0).amax(),
        num_batches=tt["leaf"].sum(dtype=_I32),
        batch_width=torch.where(tt["leaf"], tt["count"], 0).amax(),
        bucket_rows=tuple(rows), bucket_widths=tuple(widths),
        num_chunks=_chunk_need(ss),
        sparse_rows=socc, batch_sparse_rows=tocc,
    )


def _qcap(x, floor: int = 1024) -> int:
    """Quantized pair budget: the ladder {1, 1.25, 1.5, 1.75} * 2^k.

    Coarse enough that replans at steady state never see a new shape
    from need jitter, fine enough (+25% steps) that the padded traversal
    work tracks the true pair counts."""
    v = floor
    while v < int(x):
        v += (1 << (v.bit_length() - 1)) // 4
    return v


#: Shapes each devtree phase has run at (the counterpart of the
#: reference's compiled executables; a new one logs a "compile" event).
_SEEN: dict = {}


def _logged(label, key, fn, *args, **kwargs):
    out, _ = _events.log_compiles(
        label, fn, *args, key=key, seen=_SEEN.setdefault(label, set()),
        owner="devtree", site="devtree.build", **kwargs)
    return out


def _flatten(tree):
    """The 0-d tensors of a nested dict/tuple, in a fixed order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for x in tree for v in _flatten(x)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(_unflatten(x, it) for x in tree)
    return next(it)


def _read(tree, *floats):
    """The needs tree as Python ints, and `floats` (0-d tensors) as
    Python floats, in ONE device-to-host transfer (the rebuild's only
    read-back). f64 holds every count exactly."""
    leaves = _flatten(tree)
    with _rt.explicit_sync("devtree_needs"):
        vals = torch.stack([v.to(torch.float64)
                            for v in leaves + list(floats)]).tolist()
    ints = _unflatten(tree, iter(int(v) for v in vals[:len(leaves)]))
    return (ints,) + tuple(vals[len(leaves):])


def _block(device: torch.device) -> None:
    """Wait for the device (the synchronous path's phase timing)."""
    if device.type == "cuda":
        # lint: disable=OB001 — the synchronous build blocks by contract:
        # its per-phase ms (build_ms) are the wait's product
        torch.cuda.synchronize(device)


class _LazyStruct:
    """Materialize-on-first-touch proxy for the host `Tree` / `Batches`.

    The step loop never reads the host trees; diagnostics do. Deferring
    the device-to-host copy to that first access keeps the budgeted
    rebuild free of position transfers. The geometry is as of build time
    (host plans keep their build-time tree across refits too)."""

    def __init__(self, thunk):
        self._thunk = thunk
        self._obj = None

    def _materialize(self):
        if self._obj is None:
            self._obj = self._thunk()
        return self._obj

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._materialize(), name)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _materialize_tree(dev, node_lo, node_hi) -> Tree:
    depth = dev["depth"]
    srows = tuple(dev["sparse_rows"])
    occ = tuple(dev["sparse_occ"])
    sd = min(depth, SPLIT_DEPTH)
    off, md, level_d, parent_d = _static_nodes(sd)
    spans, m = _level_spans(depth, srows)
    count = _np(dev["node_count"]).astype(np.int64)
    start = _np(dev["node_start"]).astype(np.int64)
    active = _np(dev["node_active"])
    leafm = _np(dev["node_leaf"])
    code = _np(dev["node_code"]).astype(np.int64)
    lo = _np(node_lo)[:m]
    hi = _np(node_hi)[:m]
    level = np.concatenate(
        [level_d.astype(np.int64)]
        + [np.full(r, sd + 1 + i, np.int64)
           for i, (_, r) in enumerate(spans[sd + 1:])])
    parent = np.full(m, -1, np.int64)
    parent[:md] = parent_d
    for i, (base, r) in enumerate(spans[sd + 1:]):
        no = int(occ[i])
        pc = code[base:base + no] >> 3
        if i == 0:
            parent[base:base + no] = off[sd] + pc
        else:
            pbase, _ = spans[sd + i]
            pcode = code[pbase:pbase + int(occ[i - 1])]
            parent[base:base + no] = pbase + np.searchsorted(pcode, pc)
    children = np.full((m, 8), -1, np.int64)
    for l in range(sd):
        k = np.arange(8 ** l)
        par = off[l] + k
        kids = off[l + 1] + (k[:, None] * 8 + np.arange(8)[None, :])
        link = (active[kids] & active[par][:, None]
                & ~leafm[par][:, None])
        children[par] = np.where(link, kids, -1)
    for i, (base, r) in enumerate(spans[sd + 1:]):
        no = int(occ[i])
        gid = base + np.arange(no)
        par = parent[base:base + no]
        slot = code[base:base + no] & 7
        link = active[gid] & active[par] & ~leafm[par]
        # lint: disable=DV002 — host numpy: the diagnostics tree the lazy
        # struct materializes, never the device build
        children[par[link], slot[link]] = gid[link]
    n_leaves = int(dev["n_leaves"])
    leaf_ids = _np(dev["leaf_ids"])[:n_leaves].astype(np.int64)
    leaf_index = np.full(m, -1, np.int64)
    leaf_index[leaf_ids] = np.arange(n_leaves)
    return Tree(
        lo=lo, hi=hi, center=0.5 * (lo + hi),
        radius=0.5 * np.linalg.norm(hi - lo, axis=1),
        start=start, count=count, level=level,
        parent=parent, children=children,
        is_leaf=leafm, perm=_np(dev["src_perm"]).astype(np.int64),
        leaf_ids=leaf_ids, leaf_index=leaf_index,
    )


def _materialize_batches(dev) -> Batches:
    nb = int(dev["n_batches"])
    lo = _np(dev["b_lo"])[:nb]
    hi = _np(dev["b_hi"])[:nb]
    return Batches(
        center=0.5 * (lo + hi),
        radius=0.5 * np.linalg.norm(hi - lo, axis=1),
        start=_np(dev["b_start"])[:nb].astype(np.int64),
        count=_np(dev["b_count"])[:nb].astype(np.int64),
        perm=_np(dev["tgt_perm"]).astype(np.int64),
        half_extent=0.5 * (hi - lo),
    )


def prepare_plan_device(
    targets, sources, *, theta, degree, leaf_size, batch_size,
    space=_FREE, skin=0.0, capacities=None,
    headroom: float = 1.15, base: int = 8,
    depth=None, batch_depth=None, pair_caps=None,
) -> "_eval.Plan":
    """Device-resident `prepare_plan`: the same contract, no host tree.

    `targets` / `sources` are (N, 3) tensors on the plan's device (the
    same tensor for the N-body setting: one sort serves both trees). With
    ``capacities=None`` (first build) an occupancy + 1-D needs probe and
    a count-only traversal size the budget; with a `Capacities` (the
    replan path) the build runs at the budgeted shapes and reads back
    only the needs vector. An overflow grows the budget geometrically (a
    `capacity_growth` event and a rebuild, the host `pad_plan` path's
    contract).

    `depth` / `batch_depth` override the derived octree depths (a replan
    that keeps its budget keeps them). `pair_caps` carries the traversal
    budgets (frontier pairs, direct runs, skin runs) of a previous plan.
    """
    if skin < 0.0:
        raise ValueError(f"skin must be >= 0, got {skin}")
    with _trace.span("plan.build"):
        b = _DeviceBuild(
            targets, sources, theta=theta, degree=degree,
            leaf_size=leaf_size, batch_size=batch_size, space=space,
            skin=skin, headroom=headroom, base=base,
            depth=depth, batch_depth=batch_depth)
        return b.run_sync(capacities, pair_caps)


def dispatch_plan_device(
    targets, sources, *, theta, degree, leaf_size, batch_size,
    capacities, pair_caps, space=_FREE, skin=0.0,
    headroom: float = 1.15, base: int = 8,
    depth=None, batch_depth=None,
) -> "PendingDevicePlan":
    """Enqueue a full device replan and return without waiting.

    The double-buffered rebuild: the sort, build and list passes are
    launched at the existing budget (`capacities` and `pair_caps` are
    REQUIRED: only a budgeted replan can skip the needs probe), on a
    side CUDA stream that first waits for the current stream, and
    nothing is read back. The caller keeps using its live plan;
    `PendingDevicePlan.finalize()` later waits for what is left
    (``wait_ms``) and assembles the shadow plan. On the CPU the same
    passes run at once, with no stream.
    """
    if skin < 0.0:
        raise ValueError(f"skin must be >= 0, got {skin}")
    if capacities is None or pair_caps is None:
        raise ValueError(
            "dispatch_plan_device requires an existing capacities budget "
            "and pair_caps (the async path never probes)")
    b = _DeviceBuild(
        targets, sources, theta=theta, degree=degree,
        leaf_size=leaf_size, batch_size=batch_size, space=space,
        skin=skin, headroom=headroom, base=base,
        depth=depth, batch_depth=batch_depth)
    return b.dispatch(capacities, pair_caps)


#: One side stream per CUDA device for the shadow builds.
_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _DeviceBuild:
    """One device build's context: sorted inputs, static dims, and the
    build/list/grow/assemble steps behind both the synchronous
    (`prepare_plan_device`) and the double-buffered
    (`dispatch_plan_device` -> `PendingDevicePlan`) entry points."""

    def __init__(self, targets, sources, *, theta, degree, leaf_size,
                 batch_size, space, skin, headroom, base, depth,
                 batch_depth):
        self.xt, self.xs = targets, sources
        self.shared = targets is sources
        self.device = targets.device
        self.n_t, self.n_s = int(targets.shape[0]), int(sources.shape[0])
        if self.n_t == 0 or self.n_s == 0:
            raise ValueError("cannot build a tree over zero particles")
        self.d_src = (depth if depth is not None
                      else depth_for(self.n_s, leaf_size))
        self.d_tgt = (batch_depth if batch_depth is not None
                      else depth_for(self.n_t, batch_size))
        self.sd = min(self.d_src, SPLIT_DEPTH)
        self.tsd = min(self.d_tgt, SPLIT_DEPTH)
        self.bits = _morton.BITS
        self.off = _static_nodes(self.sd)[0]
        self.theta, self.skin = float(theta), float(skin)
        self.degree = int(degree)
        self.space = space
        self.headroom, self.base = headroom, base
        self.static_kw = dict(depth=self.d_src, tdepth=self.d_tgt,
                              leaf_size=int(leaf_size),
                              batch_size=int(batch_size), bits=self.bits)
        self.build_ms = {}

    # -- phases --------------------------------------------------------

    def _key(self, *dims):
        return (str(self.device), str(self.xs.dtype), self.n_s, self.n_t,
                tuple(sorted(self.static_kw.items()))) + dims

    def sort(self, block: bool):
        t0 = time.perf_counter()
        with _trace.span("devtree.morton"):
            out = _logged("devtree.morton", self._key(),
                          _morton.sort_phase, self.xs, space=self.space)
            self.xs_sorted, self.codes_s, self.order_s = out
            if self.shared:
                self.xt_sorted = self.xs_sorted
                self.codes_t, self.order_t = self.codes_s, self.order_s
            else:
                self.xt_sorted, self.codes_t, self.order_t = _logged(
                    "devtree.morton", self._key(), _morton.sort_phase,
                    self.xt, space=self.space)
            if block:
                _block(self.device)
        self.build_ms["morton"] = (time.perf_counter() - t0) * 1e3

    def run_build(self, caps):
        dims = _build_dims(caps)
        return _logged(
            "devtree.build", self._key(dims), _build_phase, self.xs_sorted,
            self.codes_s, self.xt_sorted, self.codes_t, self.order_t,
            dims=dims, **self.static_kw)

    def run_lists(self, struct, widths, pcaps, caps):
        spans, _ = _level_spans(self.d_src, caps.sparse_rows)
        return _logged(
            "devtree.lists", self._key(_build_dims(caps), widths, pcaps),
            _lists.lists_phase,
            struct["node_lo"], struct["node_hi"], struct["node_count"],
            struct["node_start"], struct["node_active"],
            struct["node_leaf"], struct["node_code"],
            struct["leaf"]["start"], struct["leaf"]["valid"],
            struct["batch"]["lo"], struct["batch"]["hi"],
            struct["batch"]["valid"],
            widths=widths, pair_caps=pcaps, depth=self.d_src,
            off=self.off, sparse=tuple(spans[self.sd + 1:]),
            theta=self.theta, skin=self.skin, degree=self.degree,
            space=self.space)

    def full_need(self, bneed, lneed, srows_layout):
        _, m_tot = _level_spans(self.d_src, tuple(srows_layout))
        return dict(
            bneed, num_nodes=m_tot, depth=self.d_src + 1, upward_rows=(),
            approx_width=lneed["approx_width"],
            direct_width=lneed["direct_width"],
            skin_direct_width=lneed["skin_direct_width"])

    def guess_pairs(self, nb_cap):
        return (tuple(_qcap(min(nb_cap * 8 ** l, 128 * nb_cap))
                      for l in range(self.d_src + 1)),
                _qcap(32 * nb_cap), _qcap(4 * nb_cap))

    def fit_pairs(self, pcaps, lneed):
        return (tuple(max(c, _qcap(self.headroom * f)) for c, f in
                      zip(pcaps[0], lneed["frontier_pairs"])),
                max(pcaps[1], _qcap(self.headroom * lneed["run_pairs"])),
                max(pcaps[2], _qcap(self.headroom * lneed["skin_pairs"])))

    def grow(self, caps, pair_caps, synced):
        grown = _clamp_nodes(
            caps.grown_to_fit_need(
                self.full_need(synced, synced, caps.sparse_rows)),
            self.d_src)
        return grown, self.fit_pairs(pair_caps, synced)

    def record_growth(self, grown, grown_pairs):
        _events.record("capacity_growth", "devtree.prepare_plan_device",
                       owner="devtree", site="devtree.build",
                       key=repr((_build_dims(grown),) + grown_pairs))

    def validate(self, caps):
        if caps.depth != self.d_src + 1:
            raise ValueError(
                f"device capacities are bound to the octree depth: "
                f"budget has depth {caps.depth}, this build derives "
                f"{self.d_src + 1} (N={self.n_s})")
        if (len(caps.sparse_rows) != self.d_src - self.sd
                or len(caps.batch_sparse_rows) != self.d_tgt - self.tsd):
            raise ValueError(
                f"device capacities are bound to the hybrid split: "
                f"budget has {len(caps.sparse_rows)} source / "
                f"{len(caps.batch_sparse_rows)} target sparse levels, "
                f"this build derives {self.d_src - self.sd} / "
                f"{self.d_tgt - self.tsd} (split depth {SPLIT_DEPTH})")
        _, m_tot = _level_spans(self.d_src, caps.sparse_rows)
        if caps.num_nodes < m_tot + 1:
            raise ValueError(
                f"device capacities too small for the hybrid octree: "
                f"num_nodes budget {caps.num_nodes} < {m_tot} rows "
                f"+ scratch")

    def lanes(self, struct, caps, pair_caps):
        return self.run_lists(struct, (caps.approx_width, caps.direct_width,
                                       caps.skin_direct_width),
                              pair_caps, caps)

    def read_back(self, struct, lneed, t_slack, f_slack):
        """The rebuild's one read-back: needs, and the two slacks."""
        return _read(dict(struct["need"], **lneed), t_slack, f_slack)

    # -- entry points --------------------------------------------------

    def probe(self):
        """First build: stage-0 occupancy -> structural needs -> probe
        build + count-only lists -> budget."""
        t1 = time.perf_counter()
        with _trace.span("devtree.needs"):
            rounder = functools.partial(_round_need, self.headroom,
                                        self.base)
            if self.d_src > self.sd or self.d_tgt > self.tsd:
                (socc, tocc), = _read(_occupancy_phase(
                    self.codes_s, self.codes_t, depth=self.d_src,
                    tdepth=self.d_tgt, bits=self.bits))
                srows0 = tuple(rounder(v) for v in socc)
                tsrows0 = tuple(rounder(v) for v in tocc)
            else:
                srows0, tsrows0 = (), ()
            bneed, = _read(_needs_phase(
                self.xs_sorted, self.codes_s, self.xt_sorted, self.codes_t,
                srows=srows0, tsrows=tsrows0, **self.static_kw))
            probe = _clamp_nodes(_eval.Capacities.for_need(
                self.full_need(bneed, dict(approx_width=1, direct_width=1,
                                           skin_direct_width=1), srows0),
                headroom=self.headroom, base=self.base), self.d_src)
            struct = self.run_build(probe)
            probe_pairs = self.guess_pairs(probe.num_batches)
            _, lneed, _, _ = self.run_lists(struct, (0, 0, 0), probe_pairs,
                                            probe)
            lneed, = _read(lneed)
            caps = _clamp_nodes(_eval.Capacities.for_need(
                self.full_need(bneed, lneed, probe.sparse_rows),
                headroom=self.headroom, base=self.base), self.d_src)
            pair_caps = self.fit_pairs(
                ((1,) * (self.d_src + 1), 1, 1), lneed)
        self.build_ms["needs"] = (time.perf_counter() - t1) * 1e3
        return caps, pair_caps

    def converge(self, caps, pair_caps, tries: int):
        """Build and list at `caps` until the needs fit (each overflow a
        `capacity_growth` event); returns what `assemble` takes."""
        for _ in range(tries):
            tb = time.perf_counter()
            with _trace.span("devtree.build"):
                struct = self.run_build(caps)
                _block(self.device)
            tl = time.perf_counter()
            self.build_ms["build"] = (self.build_ms.get("build", 0.0)
                                      + (tl - tb) * 1e3)
            with _trace.span("devtree.lists"):
                lists, lneed, t_slack, f_slack = self.lanes(struct, caps,
                                                            pair_caps)
                _block(self.device)
            self.build_ms["lists"] = (self.build_ms.get("lists", 0.0)
                                      + (time.perf_counter() - tl) * 1e3)
            synced, t_slack, f_slack = self.read_back(struct, lneed,
                                                      t_slack, f_slack)
            grown, grown_pairs = self.grow(caps, pair_caps, synced)
            if grown == caps and grown_pairs == pair_caps:
                return caps, pair_caps, struct, lists, synced, t_slack, \
                    f_slack
            self.record_growth(grown, grown_pairs)
            caps, pair_caps = grown, grown_pairs
        raise RuntimeError("devtree capacity growth did not converge")

    def run_sync(self, capacities, pair_caps) -> "_eval.Plan":
        self.sort(block=True)
        caps = capacities
        if caps is None:
            caps, pair_caps = self.probe()
        self.validate(caps)
        if pair_caps is None:
            pair_caps = self.guess_pairs(caps.num_batches)
        return self.assemble(*self.converge(caps, pair_caps, 8))

    def dispatch(self, caps, pair_caps) -> "PendingDevicePlan":
        self.validate(caps)
        t0 = time.perf_counter()
        stream = event = None
        with _trace.span("devtree.dispatch"):
            if self.device.type == "cuda":
                stream = _side_stream(self.device)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                # the caller may free its positions while the side stream
                # still reads them
                self.xt.record_stream(stream)
                self.xs.record_stream(stream)
                ctx = torch.cuda.stream(stream)
            else:
                ctx = contextlib.nullcontext()
            with ctx:
                self.sort(block=False)
                struct = self.run_build(caps)
                lists, lneed, t_slack, f_slack = self.lanes(struct, caps,
                                                            pair_caps)
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
        self.build_ms["dispatch"] = (time.perf_counter() - t0) * 1e3
        return PendingDevicePlan(self, caps, pair_caps, struct, lists,
                                 lneed, t_slack, f_slack, stream, event)

    def assemble(self, caps, pair_caps, struct, lists, synced,
                 t_slack, f_slack) -> "_eval.Plan":
        tf = time.perf_counter()
        with _trace.span("devtree.assemble"):
            arrays = dict(
                src_sorted=self.xs_sorted,
                src_perm=self.order_s,
                tgt_batched=struct["tgt_batched"],
                gather_index=struct["gather_index"].long(),
                leaf_gather=struct["leaf"]["gather"].long(),
                node_lo=struct["node_lo"],
                node_hi=struct["node_hi"],
                approx_idx=lists["approx_idx"],
                direct_idx=lists["direct_idx"],
                approx_skin=lists["approx_skin"],
                skin_direct=lists["skin_direct"],
                skin_direct_node=lists["skin_direct_node"],
                tgt_mask=struct["tgt_mask"],
                bucket_gather=tuple(g.long()
                                    for g in struct["bucket_gather"]),
                bucket_nodes=tuple(g.long()
                                   for g in struct["bucket_nodes"]),
                parent_of=struct["parent_of"].long(),
                mc_chunks=struct["mc_chunks"],
                mc_chunk_ptr=struct["mc_chunk_ptr"],
            )
            dev = dict(
                depth=self.d_src, tdepth=self.d_tgt,
                num_nodes=_level_spans(self.d_src, caps.sparse_rows)[1],
                node_count=struct["node_count"],
                node_start=struct["node_start"],
                node_active=struct["node_active"],
                node_leaf=struct["node_leaf"],
                node_code=struct["node_code"],
                sparse_rows=caps.sparse_rows,
                sparse_occ=tuple(synced["sparse_rows"]),
                batch_sparse_occ=tuple(synced["batch_sparse_rows"]),
                leaf_ids=struct["leaf"]["ids"],
                n_leaves=synced["num_leaves"],
                b_lo=struct["batch"]["lo"], b_hi=struct["batch"]["hi"],
                b_start=struct["batch"]["start"],
                b_count=struct["batch"]["count"],
                n_batches=synced["num_batches"],
                src_perm=self.order_s, tgt_perm=self.order_t,
                pair_caps=pair_caps,
            )
            used = synced["approx_total"] + synced["direct_total"]
            total = caps.num_batches * (caps.approx_width
                                        + caps.direct_width)
            plan = _eval.Plan(
                arrays=arrays,
                tree=_LazyStruct(functools.partial(
                    _materialize_tree, dev, arrays["node_lo"],
                    arrays["node_hi"])),
                batches=_LazyStruct(functools.partial(
                    _materialize_batches, dev)),
                padding_waste=1.0 - used / max(total, 1),
                num_targets=self.n_t, num_sources=self.n_s,
                mac_slack=_interaction.scaled_mac_slack(
                    self.theta, t_slack, f_slack),
                theta_slack=t_slack, fold_slack=f_slack, skin=self.skin,
                capacities=caps, scratch_node=caps.scratch_node,
                build_ms=self.build_ms, build_backend="device", dev=dev,
            )
        self.build_ms["assemble"] = (time.perf_counter() - tf) * 1e3
        return plan


def _round_need(headroom: float, base: int, v: int) -> int:
    """The `Capacities.for_need` rounding, so the stage-0 occupancy probe
    picks the SAME sparse row budgets `for_need` will derive."""
    return _eval._round_up(int(np.ceil(v * headroom)), base)


class PendingDevicePlan:
    """An in-flight shadow replan (see `dispatch_plan_device`).

    Holds the enqueued build's tensors until `finalize()`, which waits
    for the event recorded behind it on the side stream (the only
    blocking point, reported as ``wait_ms``), makes the current stream
    wait for it too, reads the needs and assembles the `Plan`. If the
    budget overflowed, finalize reruns the growth loop synchronously (a
    `capacity_growth` event and a blocking rebuild, exactly the sync
    path's contract); ``grew`` says so. The pending plan owns only its
    own fresh tensors: nothing aliases the live plan, so a growth here
    never perturbs it.
    """

    def __init__(self, build, caps, pair_caps, struct, lists, lneed,
                 t_slack, f_slack, stream=None, event=None):
        self._b = build
        self._caps, self._pair_caps = caps, pair_caps
        self._struct, self._lists, self._lneed = struct, lists, lneed
        self._t_slack, self._f_slack = t_slack, f_slack
        self._stream, self._event = stream, event
        self._done = False

    def _join(self):
        """Wait for the side stream, hand its tensors to the current
        stream (`record_stream`, so the allocator does not reuse them
        under the current stream's reads) and read the needs there."""
        b = self._b
        if self._event is not None:
            with _rt.explicit_sync("replan_wait"):
                self._event.synchronize()
            cur = torch.cuda.current_stream(b.device)
            cur.wait_event(self._event)
            own = [b.xs_sorted, b.codes_s, b.order_s, b.xt_sorted,
                   b.codes_t, b.order_t, self._t_slack, self._f_slack]
            own += _tensors((self._struct, self._lists, self._lneed))
            for t in own:
                t.record_stream(cur)
        return b.read_back(self._struct, self._lneed, self._t_slack,
                           self._f_slack)

    def finalize(self):
        """Wait for the enqueued build; return (plan, wait_ms, grew)."""
        if self._done:
            raise RuntimeError("PendingDevicePlan already finalized")
        self._done = True
        b = self._b
        caps, pair_caps = self._caps, self._pair_caps
        t0 = time.perf_counter()
        with _trace.span("devtree.wait"):
            synced, t_slack, f_slack = self._join()
        wait_ms = (time.perf_counter() - t0) * 1e3
        b.build_ms["wait"] = wait_ms
        grown, grown_pairs = b.grow(caps, pair_caps, synced)
        grew = grown != caps or grown_pairs != pair_caps
        struct, lists = self._struct, self._lists
        if grew:
            # Mid-flight overflow: the dispatched tables are truncated.
            # Rerun the growth loop at the grown budget (blocking).
            b.record_growth(grown, grown_pairs)
            caps, pair_caps, struct, lists, synced, t_slack, f_slack = \
                b.converge(grown, grown_pairs, 7)
        plan = b.assemble(caps, pair_caps, struct, lists, synced,
                          t_slack, f_slack)
        return plan, wait_ms, grew


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []
