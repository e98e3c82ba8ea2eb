"""Batch-cluster interactions (Eq. 9 and Eq. 11): CUDA kernel + plain version.

Replaces `src/repro/kernels/batch_cluster.py:batch_cluster_eval_pallas`
(bodies `_body`, `_body_kahan`, `_pair_r2`). The barycentric
particle-cluster approximation has the same direct-sum form as the exact
interaction, so ONE kernel evaluates both: against leaf source particles
(direct lane, Eq. 9) or against Chebyshev points with modified charges
(approximation lane, Eq. 11).

- `batch_cluster_eval_cuda` launches `csrc/batch_cluster.cu` (one block
  per (batch, target tile), the slot loop inside the block, sources
  staged through shared memory). It is bound by fp32 operations on the
  H100; the source's header says what the design does about that.
- `batch_cluster_eval_plain` is the same function in plain PyTorch,
  chunked over batches and list slots like the reference's XLA scan, so
  it runs at 10^6 particles on the card. The CPU path and the tests use
  it; `chip_smoke.py` holds the kernel against it.

Sentinel contract: a ``-1`` slot contributes exactly zero wherever it
sits in a row (the Verlet-skin gate writes interior sentinels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.potentials import Kernel, builtin_id
from repro_torch.core.space import FREE as _FREE
from repro_torch.kernels import _build

#: Kernel launches since import (or the last reset by a caller).
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIG = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _D, _D, _D, _P)
_SIGNATURES = {"bc_eval_f32": _SIG, "bc_eval_f64": _SIG}

#: Element budget of one (batch chunk, NB, m) pairwise block in the plain
#: version.
_PAIR_BUDGET = 1 << 25

#: kThreads of csrc/batch_cluster.cu: one block per 128 targets of a row,
#: and the grid's second dimension is at most 65535 blocks.
_TARGETS_PER_BLOCK = 128


def kernel_id(kernel: Kernel) -> int:
    """The CUDA kernel's id for `kernel`; raises for user kernels."""
    kid = builtin_id(kernel)
    if kid is None:
        raise NotImplementedError(
            f"the CUDA batch-cluster kernel implements coulomb and yukawa; "
            f"kernel {kernel.name!r} runs on backend='torch' (user kernels "
            f"on CUDA: ROADMAP queue B)")
    return kid


def batch_cluster_eval_cuda(idx: torch.Tensor, par: torch.Tensor,
                            tgt: torch.Tensor, src_pts: torch.Tensor,
                            src_q: torch.Tensor, *, kernel: Kernel,
                            space=_FREE, kahan: bool = False,
                            r2_mode: str = "diff") -> torch.Tensor:
    """phi (B, NB) by one launch of the CUDA kernel.

    idx (B, S) int32 (-1 = empty slot), par the packed kernel parameters
    (`potentials.pack_params`), tgt (B, NB, 3), src_pts (C, m, 3), src_q
    (C, m), all contiguous CUDA tensors on one device, float32 or
    float64 alike. `r2_mode="matmul"` takes |x|^2+|y|^2-2x.y in free
    space; periodic spaces always take the difference form."""
    global LAUNCHES
    dev = tgt.device
    dtype = tgt.dtype
    for name, t in (("idx", idx), ("par", par), ("tgt", tgt),
                    ("src_pts", src_pts), ("src_q", src_q)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"batch_cluster_eval_cuda: {name} is on "
                             f"{t.device}, expected the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"batch_cluster_eval_cuda: {name} must be "
                             f"contiguous")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batch_cluster_eval_cuda: dtype {dtype} "
                        f"(float32 or float64)")
    if any(t.dtype != dtype for t in (par, src_pts, src_q)):
        raise TypeError("batch_cluster_eval_cuda: par, tgt, src_pts and "
                        "src_q must share one dtype")
    if idx.dtype != torch.int32:
        raise TypeError("batch_cluster_eval_cuda: idx must be int32")
    b, s = idx.shape
    _, nb, three = tgt.shape
    c, m, three_s = src_pts.shape
    if (tgt.shape[0] != b or three != 3 or three_s != 3
            or tuple(src_q.shape) != (c, m)):
        raise ValueError(
            f"batch_cluster_eval_cuda: shapes idx {tuple(idx.shape)}, tgt "
            f"{tuple(tgt.shape)}, src_pts {tuple(src_pts.shape)}, src_q "
            f"{tuple(src_q.shape)} do not match (B,S),(B,NB,3),(C,m,3),(C,m)")
    if -(-nb // _TARGETS_PER_BLOCK) > 65535:
        raise ValueError(f"batch_cluster_eval_cuda: NB={nb} exceeds the "
                         f"grid limit of {65535 * _TARGETS_PER_BLOCK} "
                         f"targets per batch row")
    if r2_mode not in ("diff", "matmul"):
        raise ValueError(f"unknown r2_mode {r2_mode!r}")
    kid = kernel_id(kernel)
    periodic = bool(space.periodic)
    lengths = space.lengths if periodic else (1.0, 1.0, 1.0)
    matmul = r2_mode == "matmul" and not periodic

    lib = _build.load("batch_cluster", _SIGNATURES)
    fn = lib.bc_eval_f32 if dtype == torch.float32 else lib.bc_eval_f64
    out = torch.empty((b, nb), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(idx.data_ptr(), par.data_ptr(), tgt.data_ptr(),
                src_pts.data_ptr(), src_q.data_ptr(), out.data_ptr(),
                b, s, nb, m, kid, int(periodic), int(kahan), int(matmul),
                *map(float, lengths), stream)
    _build.check(rc, "batch_cluster")
    if b > 0 and nb > 0:        # the C entry launches nothing otherwise
        LAUNCHES += 1
    return out


def batch_cluster_eval_plain(idx: torch.Tensor, tgt: torch.Tensor,
                             src_pts: torch.Tensor, src_q: torch.Tensor,
                             params=None, *, kernel: Kernel, space=_FREE,
                             kahan: bool = False,
                             r2_mode: str = "diff") -> torch.Tensor:
    """phi (B, NB), the same function in plain PyTorch (any device).

    A loop over batch chunks and list slots bounds the (chunk, NB, m)
    intermediate; Kahan compensates across slots in list order, as the
    kernel does."""
    pw = kernel.pairwise_matmul if r2_mode == "matmul" else kernel.pairwise
    bsz, nb = tgt.shape[0], tgt.shape[1]
    m = src_pts.shape[1]
    dtype = tgt.dtype
    chunk = max(1, min(bsz, _PAIR_BUDGET // max(nb * m, 1)))
    out = torch.empty((bsz, nb), dtype=dtype, device=tgt.device)
    for b0 in range(0, bsz, chunk):
        tgt_b = tgt[b0:b0 + chunk]
        idx_b = idx[b0:b0 + chunk]
        phi = torch.zeros(tgt_b.shape[:2], dtype=dtype, device=tgt.device)
        comp = torch.zeros_like(phi)
        for s in range(idx.shape[1]):
            ids = idx_b[:, s]
            safe = ids.clamp(min=0).long()
            g = pw(tgt_b, src_pts[safe], params, space)   # (bc, NB, m)
            valid = (ids >= 0).to(dtype)
            pot = torch.einsum("bnm,bm,b->bn", g, src_q[safe], valid)
            if kahan:
                y = pot - comp
                t = phi + y
                comp = (t - phi) - y
                phi = t
            else:
                phi = phi + pot
        out[b0:b0 + chunk] = phi
    return out
