"""Morton (Z-order) codes and the radix ordering, on the device.

Port of `repro/devtree/morton.py`. The device build replaces the host's
recursive midpoint bisection with a sort of 30-bit Morton codes (10 bits
per dimension), the standard GPU tree-construction ordering (Gaburov &
Bedorf, arXiv:1005.5384). Sorting by code makes every octree cell, at
every level, own a contiguous run of the sorted particles, because a
depth-``l`` cell is exactly a 3l-bit code prefix: the invariant the host
`build_tree` gives with its permutation, so the executors work unchanged.

Periodic plans quantize WRAPPED coordinates against the static box
(`PeriodicBox.origin/lengths`), so the octree never straddles the
boundary; free space quantizes against the bounding box of the data,
computed on the device. Every step is a tensor op on the points' device:
nothing here waits for the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.space import _consts

# 3*BITS = 30-bit codes fit int32.
BITS = 10

#: Sentinel code for padded rows of a COMPACTED (sparse) cell table.
#: Strictly above every real prefix (codes < 8^MAX_DEPTH = 2^24) yet
#: small enough that `PAD_CODE * 8 + 8` still fits int32, so child-code
#: arithmetic on padded rows never overflows into negative codes that
#: would break `searchsorted` against an ascending table.
PAD_CODE = 1 << 27


def prefix(codes: torch.Tensor, level: int, bits: int = BITS) -> torch.Tensor:
    """Depth-``level`` cell of each particle: the leading 3*level bits."""
    return codes >> (3 * (bits - level))


def spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` to every third bit (magic numbers)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def interleave3(ux: torch.Tensor, uy: torch.Tensor,
                uz: torch.Tensor) -> torch.Tensor:
    """Morton code with x in the highest bit of each triple."""
    return (spread3(ux) << 2) | (spread3(uy) << 1) | spread3(uz)


def quantize(x: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor,
             bits: int = BITS) -> torch.Tensor:
    """Map coords to integer cells in [0, 2^bits) (int32, clipped)."""
    u = torch.floor((x - lo) * inv_ext).to(torch.int32)
    return u.clamp(0, (1 << bits) - 1)


def morton_codes(x: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor,
                 bits: int = BITS) -> torch.Tensor:
    u = quantize(x, lo, inv_ext, bits)
    return interleave3(u[:, 0], u[:, 1], u[:, 2])


def quantization_box(x: torch.Tensor, space):
    """(lo, inv_ext) for the quantization grid.

    Periodic: the static cell, identical for every rebuild, so codes
    (and hence tree topology for unmoved particles) are reproducible.
    Free space: the data's bounding box. The scale backs off 8 ulp so
    the max coordinate lands in the top cell, and degenerate extents
    (all particles coplanar) divide safely. The scale is the reference's
    NumPy scalar of the points' precision, so the codes agree bitwise."""
    np_dt = np.float64 if x.dtype == torch.float64 else np.float32
    if getattr(space, "periodic", False):
        lo = _consts(space.origin, x)
        ext = _consts(space.lengths, x)
    else:
        lo = x.amin(0)
        ext = x.amax(0) - lo
    eps = np.finfo(np_dt).eps
    # a tensor, not a Python float: `float / tensor` multiplies by the
    # reciprocal in torch, and the codes must round as the division does
    scale = ext.new_full((), float((1 << BITS) * (1.0 - 8.0 * eps)))
    inv_ext = scale / ext.clamp(min=float(np.finfo(np_dt).tiny))
    return lo, inv_ext


def sort_phase(x: torch.Tensor, *, space):
    """Wrap, code and radix-order one point set.

    Returns ``(x_sorted, codes_sorted, order)``: ``order`` (int64) follows
    the host `Tree.perm` convention, ``order[i]`` is the input index of
    the i-th sorted particle (``x_sorted = x_wrapped[order]``). The sort
    is stable, so equal-code particles keep input order and rebuilds at
    identical positions are bit-reproducible."""
    xw = space.wrap(x)
    lo, inv_ext = quantization_box(xw, space)
    codes = morton_codes(xw, lo, inv_ext)
    codes_sorted, order = torch.sort(codes, stable=True)
    return xw[order], codes_sorted, order
