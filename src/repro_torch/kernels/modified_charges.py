"""Modified charges q_hat (Eq. 12 via Eq. 14/15): CUDA kernel + plain version.

Replaces `src/repro/kernels/modified_charges.py:modified_charges_pallas`
(body `_body`): stage 1 (Eq. 14) builds each particle's barycentric rows
with the exact-hit handling of Sec. 2.3 and q_tilde = q / (D1 D2 D3);
stage 2 (Eq. 15) accumulates the rank-1 tensor products into q_hat,
flattened k3-fastest (the `cheby.cluster_grid` order).

The work is ranged: every node's particles are a contiguous range of the
tree-ordered sources, cut into chunks of at most `CHUNK` particles by
`chunk_table` (once per plan, on the host).

- `modified_charges_ranged_cuda` launches `csrc/modified_charges.cu`: one
  block per chunk, a register-tiled outer product in IEEE FMAs (no tensor
  cores, never TF32), then a second kernel that adds each node's chunk
  partials in order. Operations bound it.
- `modified_charges_ranged_plain` is the same function in plain PyTorch,
  a chunked einsum over the same table: the CPU path, and the kernel's
  yardstick on the card.
- `modified_charges_plain` is the per-cluster form on padded (C, m)
  blocks (the reference's XLA path).
- `modified_charges_transpose_ranged_cuda` launches the transpose in the
  same source, the charge cotangent of the differentiable executor:
  qbar_j = sum over the nodes holding particle j of its rows contracted
  with the node's q_hat cotangent, over (n+1)^3. It sweeps the tiles of
  `tile_table` (at most `TILE` particles of one leaf each, with the
  leaf's chain of nodes, root first): one launch, one block per tile,
  each particle's nodes added in level order in registers (bitwise
  deterministic, no scratch, no atomics). No TPU kernel computes it (the
  reference transposes its XLA modified charges with `jax.vjp`).
  `modified_charges_transpose_ranged_plain` is its plain version over the
  same table.

Any degree runs on the card. Both kernels are templates for n+1 = 2..15
(every loop unrolled to the degree); past them (`mc_runtime` in the
source says where) they run their runtime-degree kernels, whose n+1 is
an argument and whose shared memory is bounded, so the only limit is the
memory q_hat takes. In f64 those contract on the f64 tensor cores
(`mc_chunk_rt_mma_kernel`, `mct_tile_rt_mma_kernel`; IEEE f64 products
and sums), in f32 with FFMA (`mc_chunk_rt_kernel`, `mct_tile_rt_kernel`,
which f64 also takes where the tensor-core tables pass their budget).

The forward functions take the per-dimension mapped nodes built by
`ops._cluster_nodes`, the transposed ones the boxes, mapped to the same
nodes bit for bit, so the exact-hit compare sees identical nodes. The
forward ranged functions also take a leading systems axis W on every
input but the weights (an ensemble of systems of one shape): the kernel
sweeps all W systems in one pair of launches, the plain version runs
once per system.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import cheby
from repro_torch.kernels import _build
from repro_torch.lint import runtime as _rt

#: Kernel launches since import (or the last reset by a caller): one for
#: the chunk kernel and one for `mc_reduce` per call.
LAUNCHES = 0
#: Of those, the launches of the runtime-degree chunk kernel
#: (`mc_chunk_rt_kernel`).
RUNTIME_LAUNCHES = 0
#: Launches of the transpose (`modified_charges_transpose_ranged_cuda`):
#: one per call.
TRANSPOSE_LAUNCHES = 0
#: Of those, the launches of the runtime-degree transpose
#: (`mct_tile_rt_kernel`).
TRANSPOSE_RUNTIME_LAUNCHES = 0

#: Particles per chunk at most (one CUDA block each).
CHUNK = 2048
#: Particles per tile of the transpose (`tile_table`; one CUDA block each,
#: `MCT_TILE` in the source).
TILE = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
# pts, q, nodes, w, chunks, chunk_ptr, partial, out; num_chunks,
# num_nodes, n1, systems, num_points, force_runtime; the stream
_SIG = (_P,) * 8 + (_I,) * 6 + (_P,)
# pts, qhat_bar, node_lo, node_hi, cheb, w, tiles, chain, out; num_tiles,
# num_levels, n1, force_runtime; the stream
_T_SIG = (_P,) * 9 + (_I,) * 4 + (_P,)
_SIGNATURES = {"mc_eval_f32": _SIG, "mc_eval_f64": _SIG, "mc_tile": (_I, _I),
               "mc_runtime": (_I,), "mct_eval_f32": _T_SIG,
               "mct_eval_f64": _T_SIG, "mct_tile": (),
               # the cuda tests' probes: one f64 mma (a, b, d, shape,
               # the stream) and the rows' division (a, b, q, n, dtype
               # size, the stream)
               "mc_mma_probe": (_P, _P, _P, _I, _P),
               "mc_div_probe": (_P, _P, _P, _I, _I, _P)}
#: Chain entries (tree levels) the transposed kernel reads per tile.
MAX_LEVELS = 32


def chunk_table(start, count, chunk: int = CHUNK):
    """Cut each node's range [start, start+count) into chunks.

    Returns (chunks, chunk_ptr) as int32 numpy arrays: chunks
    (num_chunks, 3) rows (node, begin, end) of at most `chunk` particles,
    each node's chunks contiguous and in order, and chunk_ptr
    (num_nodes + 1,) such that node i owns rows chunk_ptr[i] to
    chunk_ptr[i+1]. A node with count 0 owns no row."""
    start = np.asarray(start, dtype=np.int64)
    count = np.asarray(count, dtype=np.int64)
    per = -(-count // chunk)
    chunk_ptr = np.concatenate([[0], np.cumsum(per)])
    node = np.repeat(np.arange(count.shape[0]), per)
    k = np.arange(node.shape[0]) - chunk_ptr[node]
    begin = start[node] + k * chunk
    end = np.minimum(begin + chunk, start[node] + count[node])
    return (np.stack([node, begin, end], axis=1).astype(np.int32),
            chunk_ptr.astype(np.int32))


def _check(what, tensors, dtype, dev):
    for name, t in tensors.items():
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected the "
                             f"CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")


def modified_charges_ranged_cuda(pts: torch.Tensor, q: torch.Tensor,
                                 chunks: torch.Tensor,
                                 chunk_ptr: torch.Tensor,
                                 nodes: torch.Tensor, w: torch.Tensor,
                                 degree: int, *,
                                 _runtime: bool = False) -> torch.Tensor:
    """q_hat (num_nodes, (n+1)^3) by the CUDA kernel.

    pts (N, 3) and q (N,) tree-ordered particles; chunks (K, 3) and
    chunk_ptr (num_nodes + 1,) int32 from `chunk_table`; nodes
    (num_nodes, 3, n+1); w (n+1,): contiguous CUDA tensors on one device,
    the floating ones float32 or float64 alike; any degree >= 1 (the
    runtime-degree kernel past the templates). With a leading
    systems axis W on all but w (each system's chunks naming its own
    nodes and particles), (W, num_nodes, (n+1)^3) from the same two
    launches. `_runtime` takes the runtime-degree kernel at any degree
    (the checks that hold it against the templates)."""
    global LAUNCHES, RUNTIME_LAUNCHES
    if pts.dim() == 3:
        single = False
    else:
        single = True
        pts, q, chunks, chunk_ptr, nodes = (
            t.unsqueeze(0) for t in (pts, q, chunks, chunk_ptr, nodes))
    dev, dtype = pts.device, pts.dtype
    what = "modified_charges_ranged_cuda"
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} (float32 or float64)")
    _check(what, {"pts": pts, "q": q, "nodes": nodes, "w": w}, dtype, dev)
    _check(what, {"chunks": chunks, "chunk_ptr": chunk_ptr}, torch.int32,
           dev)
    if degree < 1:
        raise ValueError(f"{what}: degree {degree} (>= 1)")
    n1 = degree + 1
    systems, n = pts.shape[:2]
    num_nodes = chunk_ptr.shape[1] - 1
    k = chunks.shape[1]
    if (tuple(pts.shape) != (systems, n, 3) or tuple(q.shape) != (systems, n)
            or tuple(chunks.shape) != (systems, k, 3)
            or tuple(chunk_ptr.shape) != (systems, num_nodes + 1)
            or tuple(nodes.shape) != (systems, num_nodes, 3, n1)
            or tuple(w.shape) != (n1,)):
        raise ValueError(
            f"{what}: shapes pts {tuple(pts.shape)}, q {tuple(q.shape)}, "
            f"chunks {tuple(chunks.shape)}, chunk_ptr "
            f"{tuple(chunk_ptr.shape)}, nodes {tuple(nodes.shape)}, w "
            f"{tuple(w.shape)} do not match (W,N,3),(W,N),(W,K,3),(W,M+1),"
            f"(W,M,3,n+1),(n+1,)")
    if systems > 65535:     # the chunk kernel's grid.y
        raise ValueError(f"{what}: {systems} systems exceed the grid limit of "
                         f"65535")

    lib = _build.load("modified_charges", _SIGNATURES)
    n3 = n1 ** 3
    out = torch.empty((systems, num_nodes, n3), dtype=dtype, device=dev)
    partial = torch.empty((systems, k, n3), dtype=dtype, device=dev)
    fn = lib.mc_eval_f32 if dtype == torch.float32 else lib.mc_eval_f64
    runtime = bool(_runtime or lib.mc_runtime(n1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pts.data_ptr(), q.data_ptr(), nodes.data_ptr(), w.data_ptr(),
                chunks.data_ptr(), chunk_ptr.data_ptr(), partial.data_ptr(),
                out.data_ptr(), k, num_nodes, n1, systems, n, int(_runtime),
                stream)
    _build.check(rc, "modified_charges")
    if systems > 0:                              # what the C entry launched
        LAUNCHES += (k > 0) + (num_nodes > 0)
        RUNTIME_LAUNCHES += int(runtime and k > 0)
    return out[0] if single else out


def modified_charges_cuda(pts: torch.Tensor, q: torch.Tensor,
                          nodes: torch.Tensor, w: torch.Tensor,
                          degree: int) -> torch.Tensor:
    """q_hat (C, (n+1)^3) by the CUDA kernel for C clusters of m points.

    pts (C, m, 3), q (C, m): the ranged kernel over the flattened points,
    cluster c owning [c*m, c*m + m)."""
    c, m = q.shape
    chunks, ptr = (torch.as_tensor(a, device=pts.device) for a in
                   chunk_table(np.arange(c) * m, np.full(c, m)))
    return modified_charges_ranged_cuda(
        pts.reshape(c * m, 3), q.reshape(c * m), chunks, ptr, nodes, w,
        degree)


def modified_charges_plain(pts: torch.Tensor, q: torch.Tensor,
                           nodes: torch.Tensor, w: torch.Tensor,
                           degree: int) -> torch.Tensor:
    """q_hat (C, (n+1)^3), the same function in plain PyTorch."""
    n1 = degree + 1
    t1, d1 = cheby.bary_terms(pts[..., 0], nodes[:, None, 0, :], w)
    t2, d2 = cheby.bary_terms(pts[..., 1], nodes[:, None, 1, :], w)
    t3, d3 = cheby.bary_terms(pts[..., 2], nodes[:, None, 2, :], w)
    den = d1 * d2 * d3
    # padded/degenerate slots can cancel den to 0 in f32; their q is 0
    nz = den != 0.0
    qt = torch.where(nz, q / torch.where(nz, den, torch.ones_like(den)),
                     torch.zeros_like(den))
    g2 = (t1[..., :, None] * t2[..., None, :]).reshape(
        *t1.shape[:-1], n1 * n1)
    r3 = t3 * qt[..., None]
    qhat = torch.einsum("cmp,cmk->cpk", g2, r3)
    return qhat.reshape(-1, n1 * n1 * n1)


#: Particle slots x (n+1)^2 per batch of chunks in the plain version
#: (bounds its temporaries at 10^6 particles on the card).
_PLAIN_BUDGET = 1 << 26


def modified_charges_ranged_plain(pts: torch.Tensor, q: torch.Tensor,
                                  chunks: torch.Tensor,
                                  chunk_ptr: torch.Tensor,
                                  nodes: torch.Tensor, w: torch.Tensor,
                                  degree: int) -> torch.Tensor:
    """q_hat (num_nodes, (n+1)^3) in plain PyTorch: each chunk gathered to
    the longest chunk's width (padded slots repeat the chunk's first
    particle with charge 0), `modified_charges_plain` per chunk, and the
    chunks added into their nodes. With a leading systems axis, once per
    system."""
    if pts.dim() == 3:
        return torch.stack([
            modified_charges_ranged_plain(pts[i], q[i], chunks[i],
                                          chunk_ptr[i], nodes[i], w, degree)
            for i in range(pts.shape[0])])
    n1 = degree + 1
    num_nodes = chunk_ptr.shape[0] - 1
    out = torch.zeros((num_nodes, n1 ** 3), dtype=pts.dtype,
                      device=pts.device)
    if chunks.shape[0] == 0:
        return out
    node, begin, end = chunks.long().unbind(1)
    with _rt.explicit_sync("plain_width"):      # the plain version's read
        width = max(1, int((end - begin).max()))
    step = max(1, _PLAIN_BUDGET // (width * n1 * n1))
    ar = torch.arange(width, device=pts.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for s in range(0, chunks.shape[0], step):
        b, e, nd = begin[s:s + step], end[s:s + step], node[s:s + step]
        idx = b[:, None] + ar
        valid = idx < e[:, None]
        idx = torch.where(valid, idx, b[:, None])
        part = modified_charges_plain(
            pts[idx], torch.where(valid, q[idx], zero), nodes[nd], w, degree)
        out.index_add_(0, nd, part)
    return out


def tile_table(chunks: torch.Tensor, parent_of: torch.Tensor,
               num_levels: int, num_points: int, tile: int = TILE):
    """The transposed kernel's work table, built from a chunk table on its
    device with tensor ops only (no host read).

    chunks (K, 3) rows (node, begin, end) of at most CHUNK particles,
    each node's range cut in order (`chunk_table`); parent_of
    (num_nodes,) each node's parent, -1 at the root. The leaves are the
    chunks' nodes that no chunk's node names as its parent. Each leaf
    chunk is cut into tiles of at most `tile` particles (the last of
    ceil(CHUNK / tile) takes the rest of a longer row); a tile's chain
    is its leaf and the leaf's ancestors, root first, -1 past the leaf,
    over `num_levels` columns (the tree's levels; 1: the leaf alone).
    The tiles come first, in chunk order; then empty rows (0, 0) up to
    S = ceil(num_points / tile) + K + 1 rows, a bound on their count
    that the shapes give; the last row covers [end of the leaves,
    num_points) with an empty chain (point-budget padding, which owns no
    chunk: the kernel writes 0 there). Returns (tiles (S, 2) int32
    [begin, end), chain (S, num_levels) int32)."""
    dev = chunks.device
    k_rows = chunks.shape[0]
    rows = -(-num_points // tile) + k_rows + 1
    node, begin, end = chunks.long().unbind(1)
    # parents with "none" (the root's -1) as num_nodes, which has none too
    none = parent_of.shape[0]
    par = torch.cat([parent_of.long(), parent_of.new_full((1,), -1,
                                                          dtype=torch.long)])
    par.masked_fill_(par < 0, none)
    real = begin < end
    up = torch.where(real, par[node], none)
    has_child = torch.zeros((none + 1,), dtype=torch.bool, device=dev)
    leaf = real & ~has_child.index_fill_(0, up, True)[node]
    # leaf first, then each ancestor, "none" past the root: (K, levels)
    anc = [torch.where(leaf, node, none)]
    for _ in range(num_levels - 1):
        anc.append(par[anc[-1]])
    anc = torch.stack(anc, 1)
    col = (anc < none).sum(1, keepdim=True) - torch.arange(
        1, num_levels + 1, device=dev)
    chain = torch.where(col >= 0, anc.gather(1, col.clamp(min=0)), -1)
    # each leaf chunk's tiles at their rank among all tiles
    per = max(1, -(-CHUNK // tile))
    count = torch.where(leaf, ((end - begin + tile - 1) // tile).clamp(
        max=per), 0)
    first = torch.cumsum(count, 0) - count
    k = torch.arange(per, device=dev)
    dest = torch.where(k < count[:, None], first[:, None] + k, rows)
    b = begin[:, None] + k * tile
    e = torch.minimum(b + tile, end[:, None])
    e[:, -1] = end                              # the rest of a longer row
    tiles = torch.zeros((rows + 1, 2), dtype=torch.long, device=dev)
    tiles[dest] = torch.stack([b, e], -1)        # unique but for the dump
    out = torch.full((rows + 1, num_levels), -1, dtype=torch.long,
                     device=dev)
    out[dest] = chain[:, None].expand(-1, per, -1)
    covered = torch.where(leaf, end, 0).amax() if k_rows else end.sum()
    tiles[rows - 1, 0] = covered
    tiles[rows - 1, 1] = num_points
    return (tiles[:rows].to(torch.int32).contiguous(),
            out[:rows].to(torch.int32).contiguous())


def modified_charges_transpose_ranged_cuda(pts: torch.Tensor,
                                           qhat_bar: torch.Tensor,
                                           tiles: torch.Tensor,
                                           chain: torch.Tensor,
                                           node_lo: torch.Tensor,
                                           node_hi: torch.Tensor,
                                           degree: int, *,
                                           _runtime: bool = False
                                           ) -> torch.Tensor:
    """qbar (N,) = the transpose of `modified_charges_ranged_cuda` applied
    to qhat_bar (num_nodes, (n+1)^3), by the CUDA kernel (one system).

    pts (N, 3) tree-ordered particles; tiles (S, 2) and chain (S, L)
    int32 from `tile_table` (the tiles cover every particle once, each
    chain lists the nodes holding its tile, root first, -1 after them;
    L <= MAX_LEVELS); node_lo and node_hi (num_nodes, 3), the boxes the
    kernel maps its nodes from (bitwise `ops._cluster_nodes`'s):
    contiguous CUDA tensors on one device, the floating ones float32 or
    float64 alike; any degree >= 1 (the runtime-degree kernel past the
    templates, or at any degree with `_runtime`). One launch, a block per
    tile."""
    global TRANSPOSE_LAUNCHES, TRANSPOSE_RUNTIME_LAUNCHES
    dev, dtype = pts.device, pts.dtype
    what = "modified_charges_transpose_ranged_cuda"
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} (float32 or float64)")
    _check(what, {"pts": pts, "qhat_bar": qhat_bar, "node_lo": node_lo,
                  "node_hi": node_hi}, dtype, dev)
    _check(what, {"tiles": tiles, "chain": chain}, torch.int32, dev)
    if degree < 1:
        raise ValueError(f"{what}: degree {degree} (>= 1)")
    n1 = degree + 1
    n = pts.shape[0]
    num_nodes, s = node_lo.shape[0], tiles.shape[0]
    levels = chain.shape[1] if chain.dim() == 2 else -1
    if (tuple(pts.shape) != (n, 3)
            or tuple(qhat_bar.shape) != (num_nodes, n1 ** 3)
            or tuple(tiles.shape) != (s, 2)
            or tuple(chain.shape) != (s, levels)
            or tuple(node_lo.shape) != (num_nodes, 3)
            or tuple(node_hi.shape) != (num_nodes, 3)):
        raise ValueError(
            f"{what}: shapes pts {tuple(pts.shape)}, qhat_bar "
            f"{tuple(qhat_bar.shape)}, tiles {tuple(tiles.shape)}, chain "
            f"{tuple(chain.shape)}, node_lo {tuple(node_lo.shape)}, node_hi "
            f"{tuple(node_hi.shape)} do not match "
            f"(N,3),(M,(n+1)^3),(S,2),(S,L),(M,3),(M,3)")
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{what}: {levels} chain levels (1..{MAX_LEVELS})")
    cheb = cheby.cheb_points_1d(degree, dtype, dev)
    w = cheby.bary_weights_1d(degree, dtype, dev)

    lib = _build.load("modified_charges", _SIGNATURES)
    out = torch.empty((n,), dtype=dtype, device=dev)
    fn = lib.mct_eval_f32 if dtype == torch.float32 else lib.mct_eval_f64
    runtime = bool(_runtime or lib.mc_runtime(n1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pts.data_ptr(), qhat_bar.data_ptr(), node_lo.data_ptr(),
                node_hi.data_ptr(), cheb.data_ptr(), w.data_ptr(),
                tiles.data_ptr(), chain.data_ptr(), out.data_ptr(), s, levels,
                n1, int(_runtime), stream)
    _build.check(rc, "modified_charges transpose")
    if s > 0:                                    # what the C entry launched
        TRANSPOSE_LAUNCHES += 1
        TRANSPOSE_RUNTIME_LAUNCHES += int(runtime)
    return out


def modified_charges_transpose_ranged_plain(pts: torch.Tensor,
                                            qhat_bar: torch.Tensor,
                                            tiles: torch.Tensor,
                                            chain: torch.Tensor,
                                            node_lo: torch.Tensor,
                                            node_hi: torch.Tensor,
                                            degree: int,
                                            magnitude: bool = False
                                            ) -> torch.Tensor:
    """qbar (N,), the transpose in plain PyTorch over the same table: each
    (tile, chain level) with a node is a range of particles contracted
    against that node's q_hat cotangent, in the chunked form of
    `modified_charges_ranged_plain`, and the values added into their
    particles (`index_add_`) level by level. A particle in no tile, or in
    a tile with an empty chain, gets 0. With ``magnitude=True`` the same
    sums of the terms' magnitudes, |t1 t2 t3 qhat_bar / den|: per
    particle the scale of the rounding in its sum, against which the
    kernel is held. The nodes are `ops._cluster_nodes`'s."""
    n1 = degree + 1
    out = torch.zeros((pts.shape[0],), dtype=pts.dtype, device=pts.device)
    nodes = cheby.map_points(
        cheby.cheb_points_1d(degree, pts.dtype, pts.device),
        node_lo[..., None], node_hi[..., None])
    w = cheby.bary_weights_1d(degree, pts.dtype, pts.device)
    levels = chain.shape[1]
    node = chain.long().t().reshape(-1)          # level-major rows
    begin, end = (t.long().repeat(levels) for t in tiles.unbind(1))
    with _rt.explicit_sync("plain_width"):      # the plain version's read
        keep = (node >= 0) & (begin < end)
        node, begin, end = node[keep], begin[keep], end[keep]
        width = max(1, int((end - begin).max())) if node.numel() else 1
    if node.numel() == 0:
        return out
    step = max(1, _PLAIN_BUDGET // (width * n1 * n1))
    ar = torch.arange(width, device=pts.device)
    qg = qhat_bar.reshape(-1, n1, n1, n1)
    for s in range(0, node.shape[0], step):
        b, e, nd = begin[s:s + step], end[s:s + step], node[s:s + step]
        idx = b[:, None] + ar
        valid = idx < e[:, None]
        idx = torch.where(valid, idx, b[:, None])
        y = pts[idx]                                     # (c, width, 3)
        nds = nodes[nd][:, None]                         # (c, 1, 3, n1)
        t1, d1 = cheby.bary_terms(y[..., 0], nds[..., 0, :], w)
        t2, d2 = cheby.bary_terms(y[..., 1], nds[..., 1, :], w)
        t3, d3 = cheby.bary_terms(y[..., 2], nds[..., 2, :], w)
        den = d1 * d2 * d3
        nz = den != 0.0
        qn = qg[nd]
        if magnitude:
            t1, t2, t3, den, qn = (t.abs() for t in (t1, t2, t3, den, qn))
        r3 = torch.einsum("cmz,cxyz->cmxy", t3, qn)
        r2 = torch.einsum("cmy,cmxy->cmx", t2, r3)
        s1 = torch.einsum("cmx,cmx->cm", t1, r2)
        val = torch.where(nz & valid, s1 / torch.where(nz, den,
                                                      torch.ones_like(den)),
                          torch.zeros_like(den))
        out.index_add_(0, idx.flatten(), val.flatten())
    return out
