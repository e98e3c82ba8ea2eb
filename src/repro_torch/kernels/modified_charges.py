"""Modified charges q_hat (Eq. 12 via Eq. 14/15): CUDA kernel + plain version.

Replaces `src/repro/kernels/modified_charges.py:modified_charges_pallas`
(body `_body`): stage 1 (Eq. 14) builds each particle's barycentric rows
with the exact-hit handling of Sec. 2.3 and q_tilde = q / (D1 D2 D3);
stage 2 (Eq. 15) accumulates the rank-1 tensor products into q_hat,
flattened k3-fastest (the `cheby.cluster_grid` order).

- `modified_charges_cuda` launches `csrc/modified_charges.cu`: one block
  per (cluster, particle split), the (n+1)^3 outputs in registers,
  reduced with IEEE FMAs (no tensor cores, never TF32), and a second
  kernel, `reduce_splits`, that adds the splits in order when a level
  has too few clusters to fill the card. Operations (through
  shared-memory reads) bound it.
- `modified_charges_plain` is the same function in plain PyTorch (the
  reference's XLA path), used on the CPU and as the kernel's yardstick.

Both take the per-dimension mapped nodes (C, 3, n+1) built by
`ops._cluster_nodes`, so the exact-hit compare sees identical nodes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import cheby
from repro_torch.kernels import _build

#: Kernel launches since import (or the last reset by a caller): one for
#: `modified_charges_kernel`, and one more for `reduce_splits` when a
#: call splits its clusters' particles.
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_SIGNATURES = {"mc_eval_f32": _SIG, "mc_eval_f64": _SIG, "mc_tile": (_I,)}

MAX_DEGREE = 14  # n + 1 <= 15: the kernel's register/shared-memory tables


def split_count(num_clusters: int, m: int, tile: int, sms: int) -> int:
    """Particle splits per cluster so a launch has ~2 blocks per SM.

    Whole tiles only, and no empty split."""
    ntiles = max(1, -(-m // tile))
    want = max(1, min(ntiles, -(-2 * sms // max(num_clusters, 1))))
    per = -(-ntiles // want)
    return -(-ntiles // per)


def modified_charges_cuda(pts: torch.Tensor, q: torch.Tensor,
                          nodes: torch.Tensor, w: torch.Tensor,
                          degree: int) -> torch.Tensor:
    """q_hat (C, (n+1)^3) by the CUDA kernel.

    pts (C, m, 3) cluster particles (padding at the cluster center),
    q (C, m) charges (0 on padding), nodes (C, 3, n+1), w (n+1,):
    contiguous CUDA tensors on one device, float32 or float64 alike."""
    global LAUNCHES
    dev = pts.device
    dtype = pts.dtype
    for name, t in (("pts", pts), ("q", q), ("nodes", nodes), ("w", w)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"modified_charges_cuda: {name} is on "
                             f"{t.device}, expected the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"modified_charges_cuda: {name} must be "
                             f"contiguous")
        if t.dtype != dtype:
            raise TypeError("modified_charges_cuda: pts, q, nodes and w "
                            "must share one dtype")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"modified_charges_cuda: dtype {dtype} "
                        f"(float32 or float64)")
    if not 1 <= degree <= MAX_DEGREE:
        raise NotImplementedError(
            f"modified_charges_cuda: degree {degree} outside 1..{MAX_DEGREE}")
    c, m, three = pts.shape
    n1 = degree + 1
    if (three != 3 or tuple(q.shape) != (c, m)
            or tuple(nodes.shape) != (c, 3, n1) or tuple(w.shape) != (n1,)):
        raise ValueError(
            f"modified_charges_cuda: shapes pts {tuple(pts.shape)}, q "
            f"{tuple(q.shape)}, nodes {tuple(nodes.shape)}, w "
            f"{tuple(w.shape)} do not match (C,m,3),(C,m),(C,3,n+1),(n+1,)")

    lib = _build.load("modified_charges", _SIGNATURES)
    tile = lib.mc_tile(dtype.itemsize)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = split_count(c, m, tile, sms)
    n3 = n1 ** 3
    out = torch.empty((c, n3), dtype=dtype, device=dev)
    partial = (torch.empty((c, splits, n3), dtype=dtype, device=dev)
               if splits > 1 else out)
    fn = lib.mc_eval_f32 if dtype == torch.float32 else lib.mc_eval_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pts.data_ptr(), q.data_ptr(), nodes.data_ptr(), w.data_ptr(),
                out.data_ptr(), partial.data_ptr(), c, m, n1, splits, stream)
    _build.check(rc, "modified_charges")
    if c > 0:                   # the C entry launches nothing otherwise
        LAUNCHES += 2 if splits > 1 else 1
    return out


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

