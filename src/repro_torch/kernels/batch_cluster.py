"""Batch-cluster interactions (Eq. 9, Eq. 11): CUDA kernels + plain versions.

Replaces `src/repro/kernels/batch_cluster.py:batch_cluster_eval_pallas`
(bodies `_body`, `_body_kahan`, `_pair_r2`). The barycentric
particle-cluster approximation has the same direct-sum form as the exact
interaction, so ONE kernel evaluates both: against leaf source particles
(direct lane, Eq. 9) or against Chebyshev points with modified charges
(approximation lane, Eq. 11).

- `batch_cluster_eval_cuda` launches `csrc/batch_cluster.cu` (one block
  of four warps per (batch, 128-target tile), four targets per lane, the
  warps splitting the row's source chunks, the slot loop inside the
  block). fp32 issue and the SFU bound it on the H100; the source's
  header says what the design does about that.
- `batch_cluster_eval_plain` is the same function in plain PyTorch,
  chunked over batches and list slots like the reference's XLA scan, so
  it runs at 10^6 particles on the card. The CPU path and the tests use
  it; `chip_smoke.py` holds the kernel against it.
- `batch_cluster_field_cuda` launches `csrc/batch_cluster_field.cu`, the
  gradient twin: phi and grad_x phi = sum 2 G'(r^2) d q in one sweep, out
  (B, NB, 4) = (phi, gx, gy, gz). It is the card's counterpart of the
  reference's forces path (three forward JVPs through its XLA executor),
  not of a TPU kernel. `batch_cluster_field_plain` is its plain version:
  the analytic derivative for Coulomb and Yukawa, `torch.func.jvp` of
  `Kernel.__call__` for a user kernel.
- `batch_cluster_field_grid_cuda` launches `csrc/batch_cluster_field_grid.cu`,
  the field over each cluster's tensor-product Chebyshev grid (the
  approximation lane of the forces): it takes the clusters' 1-D nodes
  (C, 3, n+1) and q_hat (C, (n+1)^3), k3 fastest, instead of (C, m, 3)
  points, and sweeps the grid in factored form (r^2 one fma a pair, the
  x and y gradient sums per plane and per row). Its plain twin
  `batch_cluster_field_grid_plain` does the same factored arithmetic in
  tensors; on the grid's points it is `batch_cluster_field_plain`.

Kernels: the CUDA sources have hand-tuned paths for Coulomb and Yukawa
(`potentials.builtin_id`). Any other kernel runs through the same three
sources built as its *user library*, whose G and 2 G' are generated from
the kernel's torch `of_r2` (`kernels.codegen`, `kernel_id`); it builds at
first use, the grid field kernel's for the degree it is asked for. A
kernel the generator does not take raises `NotImplementedError` at the
launch; the plain versions take any kernel.

Sentinel contract: a ``-1`` slot contributes exactly zero wherever it
sits in a row (the Verlet-skin gate writes interior sentinels).

Count contract: targets are packed from slot 0 of each batch row and
source points from slot 0 of each cluster, so `tgt_count` (B,) and
`src_count` (C,) are prefix lengths. All four functions sum only over
the first ``src_count[c]`` points of cluster c, and give 0 on target
slots at or beyond ``tgt_count[b]``. None means every slot is real. The
grid field functions take target counts only: every grid point is real.

Exact hits (r^2 == 0, a particle meeting itself) add exactly 0 to phi
and to every gradient component.

Systems axis: every function also takes a leading axis of W independent
systems of one shape (an ensemble, `repro_torch.serve`) on every operand,
idx (W, B, S) and so on, each system's cluster ids indexing its own
clusters, and per-system kernel parameters (every parameter leaf a
tensor with a leading W, or a scalar shared by all). The CUDA functions
take the packed parameters as par (W, P) and sweep all W systems in one
launch (the grid's third dimension is the system); the plain versions
run the single-system sweep once per system. Without the axis a call is
the launch of one system (W = 1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.potentials import (Kernel, builtin_id, kernel_source,
                                         system_params)
from repro_torch.core.space import FREE as _FREE
from repro_torch.kernels import _build

#: Launches of the potential kernel since import (or the last reset by a
#: caller).
LAUNCHES = 0
#: Launches of the field kernel (`batch_cluster_field_cuda`), likewise.
FIELD_LAUNCHES = 0
#: Launches of the grid field kernel (`batch_cluster_field_grid_cuda`).
GRID_FIELD_LAUNCHES = 0
#: Of those, the launches of its runtime-degree kernel
#: (`grid_field_rt_kernel`: past the templates, or forced).
GRID_FIELD_RUNTIME_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# idx, par, tgt, src, q, tgt_count, src_count, out; B, S, NB, m, W, C, P,
# kernel id, periodic, kahan, matmul; the box lengths; the stream
_SIG = (_P,) * 8 + (_I,) * 11 + (_D,) * 3 + (_P,)
_SIGNATURES = {"bc_eval_f32": _SIG, "bc_eval_f64": _SIG,
               "bc_geometry": (_I,)}
# the field entries take no matmul flag
_FIELD_SIG = (_P,) * 8 + (_I,) * 10 + (_D,) * 3 + (_P,)
FIELD_SIGNATURES = {"bcf_eval_f32": _FIELD_SIG, "bcf_eval_f64": _FIELD_SIG,
                    "bcf_geometry": (_I,)}
# idx, par, tgt, nodes, q_hat, tgt_count, out; B, S, NB, n1, W, C, P,
# kernel id, periodic, kahan; the box lengths; force_runtime; the stream
_GRID_SIG = (_P,) * 7 + (_I,) * 10 + (_D,) * 3 + (_I, _P)
GRID_FIELD_SIGNATURES = {"bcfg_eval_f32": _GRID_SIG,
                         "bcfg_eval_f64": _GRID_SIG, "bcfg_tile": (_I, _I),
                         "bcfg_runtime": (_I,)}

#: Degrees the grid field kernel has templates for (n+1 = 2..15, the
#: source's kMaxN1; `bcfg_tile` and `bcfg_runtime` hold this side to it);
#: a user library instantiates the one it is built for. Every other
#: degree runs its runtime-degree kernel.
GRID_DEGREES = range(1, 15)
#: The CUDA kernels' id of a user kernel (`csrc/field_common.cuh:kUser`).
USER_ID = 2

#: Element budget of one (batch chunk, NB, m) pairwise block in the plain
#: versions.
_PAIR_BUDGET = 1 << 25

#: kTile of both CUDA sources (`bc_geometry(0)`, `bcf_geometry(0)`): one
#: block per 128 targets of a row, and the grid's second dimension is at
#: most 65535 blocks.
_TARGETS_PER_BLOCK = 128
#: kUnroll of both CUDA sources (`*_geometry(1)`): a cluster's sweep
#: rounds its point count up to a multiple of it.
_SOURCE_UNROLL = 4


def grid_tile(itemsize: int, n1: int, runtime: bool = False) -> int:
    """Targets a block of the grid field kernel (`bcfg_tile`): 32 lanes
    times two targets a lane in f32 up to n+1 = 9, else one; one on the
    runtime-degree kernel (past GRID_DEGREES, or `runtime`)."""
    runtime = runtime or n1 - 1 not in GRID_DEGREES
    return 32 * (2 if itemsize == 4 and n1 <= 9 and not runtime else 1)


def kernel_id(kernel: Kernel, params=None):
    """(id, generated header) of `kernel` on the CUDA kernels: a
    built-in's id and None (the base libraries' hand-tuned paths), or
    USER_ID and the `codegen.Generated` header of its user library
    (`potentials.kernel_source`; `params` the tree its parameters come
    in, None: its defaults). Raises NotImplementedError naming what the
    code generator does not take; backend='torch' takes any kernel."""
    kid = builtin_id(kernel)
    if kid is not None:
        return kid, None
    return USER_ID, kernel_source(kernel, params)


def _library(what: str, name: str, signatures: dict, kernel: Kernel,
             par: torch.Tensor, params: tuple | None, defines: tuple = ()):
    """(the loaded library of source `name` for `kernel`, its id): the
    base library for a built-in, else the kernel's user library, built
    with its generated header and `defines` at first use."""
    kid, src = kernel_id(kernel, params)
    if src is None:
        return _build.load(name, signatures), kid
    if par.shape[-1] != max(src.n_params, 1):
        raise NotImplementedError(
            f"{what}: kernel {kernel.name!r} has {src.n_params} scalar "
            f"parameters, which pack to {par.shape[-1]} values (a "
            f"parameter of several values is not taken on CUDA); "
            f"backend='torch' takes any kernel")
    return _build.load(name, signatures, src.text, tuple(defines)), kid


def swept_pairs(idx: torch.Tensor, nb: int, m: int,
                tgt_count: torch.Tensor | None = None,
                src_count: torch.Tensor | None = None, *,
                tile: int = _TARGETS_PER_BLOCK,
                unroll: int = _SOURCE_UNROLL) -> dict:
    """What one launch of a CUDA kernel sweeps for these inputs.

    Returns {"pairs": (target, source) pairs its tiles run, counting each
    `tile`-target tile with a real target in full and each cluster's
    points rounded up to `unroll`; "tiles": tiles with a real target;
    "tiles_launched": blocks in the grid}. Without counts every slot is
    real: what a launch without counts sweeps. The defaults are the
    generic kernels' geometry; the grid field kernel sweeps (n+1)^3 points
    a cluster in tiles of `grid_tile(itemsize, n+1)` with no rounding."""
    b = idx.shape[0]
    nt = (torch.full((b,), nb, dtype=torch.int64, device=idx.device)
          if tgt_count is None else tgt_count.long().clamp(0, nb))
    tiles = -(-nt // tile)                                  # (B,)
    valid = idx >= 0
    if src_count is None:
        n = torch.full(idx.shape, m, dtype=torch.int64, device=idx.device)
    else:
        n = src_count.long().clamp(0, m)[idx.clamp(min=0).long()]
    swept = (-(-n // unroll) * unroll * valid).sum(1)       # (B,)
    return {"pairs": float((tiles * tile * swept).sum()),
            "tiles": int(tiles.sum()),
            "tiles_launched": b * -(-nb // tile)}


def _check_count(what: str, name: str, t: torch.Tensor, shape: tuple,
                 dev) -> None:
    if t.device != dev or not t.is_cuda:
        raise ValueError(f"{what}: {name} is on {t.device}, expected the "
                         f"CUDA device {dev}")
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{what}: {name} must be a contiguous int32 tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _stacked(what: str, idx: torch.Tensor, par: torch.Tensor,
             *tensors):
    """The operands of a launch with a leading systems axis: a single
    system's (idx (B, S), par (P,)) get W = 1 as views; a stacked call's
    (idx (W, B, S)) need par (W, P). None stays None."""
    if idx.dim() == 2:
        return [None if t is None else t.unsqueeze(0)
                for t in (idx, par, *tensors)]
    if idx.dim() != 3:
        raise ValueError(f"{what}: idx must be (B, S) or (W, B, S), got "
                         f"{tuple(idx.shape)}")
    w = idx.shape[0]
    if par.dim() != 2 or par.shape[0] != w:
        raise ValueError(f"{what}: {w} systems need par ({w}, P), got "
                         f"{tuple(par.shape)}")
    return [idx, par, *tensors]


def _check_tensors(what, idx, tgt, named):
    """Device, contiguity and dtype checks shared by every launch: idx
    int32, tgt and the `named` ({name: tensor}) floating tensors on tgt's
    CUDA device, contiguous, float32 or float64 alike."""
    dev = tgt.device
    for name, t in (("idx", idx), ("tgt", tgt), *named.items()):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if tgt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {tgt.dtype} (float32 or float64)")
    if any(t.dtype != tgt.dtype for t in named.values()):
        raise TypeError(f"{what}: tgt, {', '.join(named)} must share one "
                        f"dtype")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: idx must be int32")


def _check_grid_limit(what, nb, tile):
    if -(-nb // tile) > 65535:
        raise ValueError(f"{what}: NB={nb} exceeds the grid limit of "
                         f"{65535 * tile} targets per batch row")


def _check_systems(what, w):
    if w > 65535:      # the grid's third dimension
        raise ValueError(f"{what}: {w} systems exceed the grid limit of "
                         f"65535")


def _check_inputs(what, idx, par, tgt, src_pts, src_q, tgt_count,
                  src_count):
    """Device, dtype, shape and contiguity checks of a launch on stacked
    operands; returns (W, B, S, NB, C, m)."""
    _check_tensors(what, idx, tgt, {"par": par, "src_pts": src_pts,
                                    "src_q": src_q})
    w, b, s = idx.shape
    c, m = src_q.shape[1:]
    nb = tgt.shape[2]
    if (tuple(tgt.shape) != (w, b, nb, 3)
            or tuple(src_pts.shape) != (w, c, m, 3)
            or tuple(src_q.shape) != (w, c, m)):
        raise ValueError(
            f"{what}: shapes idx {tuple(idx.shape)}, tgt "
            f"{tuple(tgt.shape)}, src_pts {tuple(src_pts.shape)}, src_q "
            f"{tuple(src_q.shape)} do not match (W,B,S),(W,B,NB,3),"
            f"(W,C,m,3),(W,C,m)")
    if tgt_count is not None:
        _check_count(what, "tgt_count", tgt_count, (w, b), tgt.device)
    if src_count is not None:
        _check_count(what, "src_count", src_count, (w, c), tgt.device)
    _check_grid_limit(what, nb, _TARGETS_PER_BLOCK)
    _check_systems(what, w)
    return w, b, s, nb, c, m


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def batch_cluster_eval_cuda(idx: torch.Tensor, par: torch.Tensor,
                            tgt: torch.Tensor, src_pts: torch.Tensor,
                            src_q: torch.Tensor, *, kernel: Kernel,
                            space=_FREE, kahan: bool = False,
                            r2_mode: str = "diff",
                            tgt_count: torch.Tensor | None = None,
                            src_count: torch.Tensor | None = None,
                            params=None) -> torch.Tensor:
    """phi (B, NB) by one launch of the CUDA kernel.

    idx (B, S) int32 (-1 = empty slot), par the packed kernel parameters
    (`potentials.pack_params`), tgt (B, NB, 3), src_pts (C, m, 3), src_q
    (C, m), all contiguous CUDA tensors on one device, float32 or
    float64 alike; tgt_count (B,) and src_count (C,) optional int32
    prefix lengths (the module's count contract). `r2_mode="matmul"`
    takes |x|^2+|y|^2-2x.y in free space; periodic spaces always take
    the difference form. With a leading systems axis on every operand
    (par (W, P)) the one launch sweeps all W systems: phi (W, B, NB).
    `params` is the tree `par` packs (None: the kernel's defaults), whose
    structure a user kernel's generated code follows."""
    global LAUNCHES
    what = "batch_cluster_eval_cuda"
    single = idx.dim() == 2
    idx, par, tgt, src_pts, src_q, tgt_count, src_count = _stacked(
        what, idx, par, tgt, src_pts, src_q, tgt_count, src_count)
    w, b, s, nb, c, m = _check_inputs(what, idx, par, tgt, src_pts, src_q,
                                      tgt_count, src_count)
    if r2_mode not in ("diff", "matmul"):
        raise ValueError(f"unknown r2_mode {r2_mode!r}")
    periodic = bool(space.periodic)
    lengths = space.lengths if periodic else (1.0, 1.0, 1.0)
    matmul = r2_mode == "matmul" and not periodic

    lib, kid = _library(what, "batch_cluster", _SIGNATURES, kernel, par,
                        params)
    fn = lib.bc_eval_f32 if tgt.dtype == torch.float32 else lib.bc_eval_f64
    out = torch.empty((w, b, nb), dtype=tgt.dtype, device=tgt.device)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = fn(idx.data_ptr(), par.data_ptr(), tgt.data_ptr(),
                src_pts.data_ptr(), src_q.data_ptr(), _ptr(tgt_count),
                _ptr(src_count), out.data_ptr(), b, s, nb, m, w, c,
                par.shape[1], kid, int(periodic), int(kahan), int(matmul),
                *map(float, lengths), stream)
    _build.check(rc, "batch_cluster")
    if w > 0 and b > 0 and nb > 0:   # the C entry launches nothing otherwise
        LAUNCHES += 1
    return out[0] if single else out


def batch_cluster_field_cuda(idx: torch.Tensor, par: torch.Tensor,
                             tgt: torch.Tensor, src_pts: torch.Tensor,
                             src_q: torch.Tensor, *, kernel: Kernel,
                             space=_FREE, kahan: bool = False,
                             tgt_count: torch.Tensor | None = None,
                             src_count: torch.Tensor | None = None,
                             params=None) -> torch.Tensor:
    """(B, NB, 4) = (phi, grad_x phi) by one launch of the field kernel.

    The arguments are those of `batch_cluster_eval_cuda` (a leading
    systems axis and `params` included), without `r2_mode`: the gradient
    needs the displacement, so the field kernel always takes the
    difference form."""
    global FIELD_LAUNCHES
    what = "batch_cluster_field_cuda"
    single = idx.dim() == 2
    idx, par, tgt, src_pts, src_q, tgt_count, src_count = _stacked(
        what, idx, par, tgt, src_pts, src_q, tgt_count, src_count)
    w, b, s, nb, c, m = _check_inputs(what, idx, par, tgt, src_pts, src_q,
                                      tgt_count, src_count)
    periodic = bool(space.periodic)
    lengths = space.lengths if periodic else (1.0, 1.0, 1.0)

    lib, kid = _library(what, "batch_cluster_field", FIELD_SIGNATURES,
                        kernel, par, params)
    fn = lib.bcf_eval_f32 if tgt.dtype == torch.float32 else lib.bcf_eval_f64
    out = torch.empty((w, b, nb, 4), dtype=tgt.dtype, device=tgt.device)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = fn(idx.data_ptr(), par.data_ptr(), tgt.data_ptr(),
                src_pts.data_ptr(), src_q.data_ptr(), _ptr(tgt_count),
                _ptr(src_count), out.data_ptr(), b, s, nb, m, w, c,
                par.shape[1], kid, int(periodic), int(kahan),
                *map(float, lengths), stream)
    _build.check(rc, "batch_cluster_field")
    if w > 0 and b > 0 and nb > 0:   # the C entry launches nothing otherwise
        FIELD_LAUNCHES += 1
    return out[0] if single else out


def _check_grid_inputs(what, idx, par, tgt, nodes, q_hat, tgt_count,
                       runtime):
    """Device, dtype, shape, contiguity and degree checks of a grid field
    launch on stacked operands; returns (W, B, S, NB, C, n1)."""
    _check_tensors(what, idx, tgt, {"par": par, "nodes": nodes,
                                    "q_hat": q_hat})
    w, b, s = idx.shape
    nb = tgt.shape[2]
    c, n1 = nodes.shape[1], nodes.shape[-1]
    if (tuple(tgt.shape) != (w, b, nb, 3)
            or tuple(nodes.shape) != (w, c, 3, n1)
            or tuple(q_hat.shape) != (w, c, n1 ** 3)):
        raise ValueError(
            f"{what}: shapes idx {tuple(idx.shape)}, tgt {tuple(tgt.shape)},"
            f" nodes {tuple(nodes.shape)}, q_hat {tuple(q_hat.shape)} do not"
            f" match (W,B,S),(W,B,NB,3),(W,C,3,n+1),(W,C,(n+1)^3)")
    if n1 < 2:
        raise ValueError(f"{what}: degree {n1 - 1} (>= 1)")
    if tgt_count is not None:
        _check_count(what, "tgt_count", tgt_count, (w, b), tgt.device)
    _check_grid_limit(what, nb, grid_tile(tgt.element_size(), n1, runtime))
    _check_systems(what, w)
    return w, b, s, nb, c, n1


def batch_cluster_field_grid_cuda(idx: torch.Tensor, par: torch.Tensor,
                                  tgt: torch.Tensor, nodes: torch.Tensor,
                                  q_hat: torch.Tensor, *, kernel: Kernel,
                                  space=_FREE, kahan: bool = False,
                                  tgt_count: torch.Tensor | None = None,
                                  params=None,
                                  _runtime: bool = False) -> torch.Tensor:
    """(B, NB, 4) = (phi, grad_x phi) over Chebyshev grids, one launch.

    idx (B, S) int32 (-1 = empty slot), par the packed kernel parameters,
    tgt (B, NB, 3), nodes (C, 3, n+1) the clusters' 1-D Chebyshev nodes
    (`ops._cluster_nodes`), q_hat (C, (n+1)^3) k3 fastest, all contiguous
    CUDA tensors on one device, float32 or float64 alike; tgt_count (B,)
    optional int32 prefix lengths. Any degree >= 1: the templates at
    GRID_DEGREES, the runtime-degree kernel past them (and at any degree
    with `_runtime`, the checks that hold it against the templates). With
    a leading systems axis on every operand (par (W, P)) the one launch
    sweeps all W systems. `params` as in `batch_cluster_eval_cuda`; a
    user kernel's library is built for its degree in GRID_DEGREES, and
    once for every degree past them."""
    global GRID_FIELD_LAUNCHES, GRID_FIELD_RUNTIME_LAUNCHES
    what = "batch_cluster_field_grid_cuda"
    single = idx.dim() == 2
    idx, par, tgt, nodes, q_hat, tgt_count = _stacked(
        what, idx, par, tgt, nodes, q_hat, tgt_count)
    w, b, s, nb, c, n1 = _check_grid_inputs(what, idx, par, tgt, nodes,
                                            q_hat, tgt_count, _runtime)
    periodic = bool(space.periodic)
    lengths = space.lengths if periodic else (1.0, 1.0, 1.0)

    lib, kid = _library(what, "batch_cluster_field_grid",
                        GRID_FIELD_SIGNATURES, kernel, par, params,
                        (f"REPRO_USER_N1="
                         f"{n1 if n1 - 1 in GRID_DEGREES else 0}",))
    fn = (lib.bcfg_eval_f32 if tgt.dtype == torch.float32
          else lib.bcfg_eval_f64)
    runtime = bool(_runtime or lib.bcfg_runtime(n1))
    out = torch.empty((w, b, nb, 4), dtype=tgt.dtype, device=tgt.device)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream(tgt.device).cuda_stream
        rc = fn(idx.data_ptr(), par.data_ptr(), tgt.data_ptr(),
                nodes.data_ptr(), q_hat.data_ptr(), _ptr(tgt_count),
                out.data_ptr(), b, s, nb, n1, w, c, par.shape[1], kid,
                int(periodic), int(kahan), *map(float, lengths),
                int(_runtime), stream)
    _build.check(rc, "batch_cluster_field_grid")
    if w > 0 and b > 0 and nb > 0:   # the C entry launches nothing otherwise
        GRID_FIELD_LAUNCHES += 1
        GRID_FIELD_RUNTIME_LAUNCHES += int(runtime)
    return out[0] if single else out


def _per_system(fn, idx, tgt, src, q, params, counts, **kw):
    """`fn` (a plain version) once per system of stacked operands, each
    with its own parameter values and counts; the results stacked."""
    return torch.stack([
        fn(idx[i], tgt[i], src[i], q[i], system_params(params, i),
           **{k: None if c is None else c[i] for k, c in counts.items()},
           **kw)
        for i in range(idx.shape[0])])


def batch_cluster_eval_plain(idx: torch.Tensor, tgt: torch.Tensor,
                             src_pts: torch.Tensor, src_q: torch.Tensor,
                             params=None, *, kernel: Kernel, space=_FREE,
                             kahan: bool = False, r2_mode: str = "diff",
                             tgt_count: torch.Tensor | None = None,
                             src_count: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """phi (B, NB), the same function in plain PyTorch (any device).

    A loop over batch chunks and list slots bounds the (chunk, NB, m)
    intermediate; Kahan compensates across slots in list order, as the
    kernel does. Points at or beyond `src_count` get charge 0, and target
    slots at or beyond `tgt_count` phi = 0 (the count contract). With a
    leading systems axis, one such sweep per system."""
    if idx.dim() == 3:
        return _per_system(batch_cluster_eval_plain, idx, tgt, src_pts,
                           src_q, params, dict(tgt_count=tgt_count,
                                               src_count=src_count),
                           kernel=kernel, space=space, kahan=kahan,
                           r2_mode=r2_mode)
    pw = kernel.pairwise_matmul if r2_mode == "matmul" else kernel.pairwise
    bsz, nb = tgt.shape[0], tgt.shape[1]
    m = src_pts.shape[1]
    dtype = tgt.dtype
    if src_count is not None:
        keep = (torch.arange(m, device=src_q.device)[None, :]
                < src_count.to(src_q.device)[:, None])
        src_q = torch.where(keep, src_q, torch.zeros_like(src_q))
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
    if tgt_count is not None:
        real = (torch.arange(nb, device=out.device)[None, :]
                < tgt_count.to(out.device)[:, None])
        out = torch.where(real, out, torch.zeros_like(out))
    return out


def field_coefficients(kernel: Kernel, r2: torch.Tensor, params=None):
    """(G(r2), 2 G'(r2)) elementwise, both exactly 0 where r2 == 0.

    Analytic for the built-in kernels (Coulomb: 2G' = -r^-3; Yukawa:
    2G' = -(1 + kappa r) e^(-kappa r) r^-3); `torch.func.jvp` of
    `Kernel.__call__` for a user kernel, whose double `where` makes the
    derivative at r2 == 0 a zero, not a NaN."""
    if params is None:
        params = kernel.params
    g = kernel(r2, params)
    kid = builtin_id(kernel)
    if kid is None:
        _, dg = torch.func.jvp(lambda t: kernel(t, params), (r2,),
                               (torch.ones_like(r2),))
        return g, 2.0 * dg
    pos = r2 > 0.0
    safe = torch.where(pos, r2, torch.ones_like(r2))
    if kid == 0:                                  # coulomb: -G^3
        c = -(g * g * g)
    else:                                         # yukawa
        (kappa,) = params
        c = -(1.0 + kappa * torch.sqrt(safe)) * g / safe
    return g, torch.where(pos, c, torch.zeros_like(c))


def batch_cluster_field_plain(idx: torch.Tensor, tgt: torch.Tensor,
                              src_pts: torch.Tensor, src_q: torch.Tensor,
                              params=None, *, kernel: Kernel, space=_FREE,
                              kahan: bool = False, r2_mode: str = "diff",
                              tgt_count: torch.Tensor | None = None,
                              src_count: torch.Tensor | None = None,
                              magnitude: bool = False) -> torch.Tensor:
    """(B, NB, 4) = (phi, grad_x phi), the field in plain PyTorch.

    The loop of `batch_cluster_eval_plain`, with the gradient
    sum 2 G'(r2) d q beside phi (d the `space` displacement target minus
    source). With ``r2_mode="matmul"`` in free space, r2 (hence G and
    G') takes the matmul form and d stays the difference, as the JVP of
    the reference's matmul r2 does. Kahan compensates all four sums
    across slots.

    With ``magnitude=True`` the same sweep sums the terms' magnitudes,
    |G q| and |2 G' d_k q|: per output, the scale of the rounding in its
    sum, against which a kernel's error is held. With a leading systems
    axis, one such sweep per system."""
    if idx.dim() == 3:
        return _per_system(batch_cluster_field_plain, idx, tgt, src_pts,
                           src_q, params, dict(tgt_count=tgt_count,
                                               src_count=src_count),
                           kernel=kernel, space=space, kahan=kahan,
                           r2_mode=r2_mode, magnitude=magnitude)
    bsz, nb = tgt.shape[0], tgt.shape[1]
    m = src_pts.shape[1]
    dtype = tgt.dtype
    matmul = r2_mode == "matmul" and not space.periodic
    if src_count is not None:
        keep = (torch.arange(m, device=src_q.device)[None, :]
                < src_count.to(src_q.device)[:, None])
        src_q = torch.where(keep, src_q, torch.zeros_like(src_q))
    chunk = max(1, min(bsz, _PAIR_BUDGET // max(4 * nb * m, 1)))
    out = torch.empty((bsz, nb, 4), dtype=dtype, device=tgt.device)
    for b0 in range(0, bsz, chunk):
        tgt_b = tgt[b0:b0 + chunk]
        idx_b = idx[b0:b0 + chunk]
        acc = torch.zeros((*tgt_b.shape[:2], 4), dtype=dtype,
                          device=tgt.device)
        comp = torch.zeros_like(acc)
        for s in range(idx.shape[1]):
            ids = idx_b[:, s]
            safe = ids.clamp(min=0).long()
            y = src_pts[safe]                                # (bc, m, 3)
            d = space.displacement(tgt_b[:, :, None, :], y[:, None, :, :])
            if matmul:
                xy = torch.einsum("bnd,bmd->bnm", tgt_b, y)
                r2 = torch.clamp((tgt_b * tgt_b).sum(-1)[..., :, None]
                                 + (y * y).sum(-1)[..., None, :] - 2.0 * xy,
                                 min=0.0)
            else:
                r2 = (d * d).sum(-1)
            g, c = field_coefficients(kernel, r2, params)
            wq = src_q[safe] * (ids >= 0).to(dtype)[:, None]  # (bc, m)
            if magnitude:
                g, c, d, wq = g.abs(), c.abs(), d.abs(), wq.abs()
            f = torch.cat([
                torch.einsum("bnm,bm->bn", g, wq)[..., None],
                torch.einsum("bnm,bnmk->bnk", c * wq[:, None, :], d)], dim=-1)
            if kahan:
                yk = f - comp
                t = acc + yk
                comp = (t - acc) - yk
                acc = t
            else:
                acc = acc + f
        out[b0:b0 + chunk] = acc
    if tgt_count is not None:
        real = (torch.arange(nb, device=out.device)[None, :]
                < tgt_count.to(out.device)[:, None])
        out = torch.where(real[..., None], out, torch.zeros_like(out))
    return out


def batch_cluster_field_grid_plain(idx: torch.Tensor, tgt: torch.Tensor,
                                   nodes: torch.Tensor, q_hat: torch.Tensor,
                                   params=None, *, kernel: Kernel,
                                   space=_FREE, kahan: bool = False,
                                   tgt_count: torch.Tensor | None = None,
                                   magnitude: bool = False) -> torch.Tensor:
    """(B, NB, 4) = (phi, grad_x phi) over Chebyshev grids, plain PyTorch.

    The function of `batch_cluster_field_plain` on each cluster's
    `cheby.cluster_grid` points, from the factored inputs of the grid
    kernel (nodes (C, 3, n+1), q_hat (C, (n+1)^3) k3 fastest), in the
    kernel's factored arithmetic: per slot, per-axis displacement tables
    d_a[k] (minimum-image folded), r^2 = d_x^2[k1] + d_y^2[k2] +
    d_z^2[k3] on the grid, w = 2 G'(r^2) q; then phi = sum G q,
    g_z = sum w d_z[k3], row sums R[k1, k2] = sum_k3 w, g_y = sum d_y[k2]
    R and g_x = sum_k1 d_x[k1] sum_k2 R. The difference form of r^2
    always. Kahan compensates the four sums across slots; target slots at
    or beyond `tgt_count` get 0. ``magnitude=True`` sums the terms'
    magnitudes as `batch_cluster_field_plain` does. With a leading systems
    axis, one such sweep per system."""
    if idx.dim() == 3:
        return _per_system(batch_cluster_field_grid_plain, idx, tgt, nodes,
                           q_hat, params, dict(tgt_count=tgt_count),
                           kernel=kernel, space=space, kahan=kahan,
                           magnitude=magnitude)
    bsz, nb = tgt.shape[0], tgt.shape[1]
    n1 = nodes.shape[-1]
    dtype = tgt.dtype
    qg = q_hat.reshape(-1, n1, n1, n1)
    chunk = max(1, min(bsz, _PAIR_BUDGET // max(4 * nb * n1 ** 3, 1)))
    out = torch.empty((bsz, nb, 4), dtype=dtype, device=tgt.device)
    for b0 in range(0, bsz, chunk):
        tgt_b = tgt[b0:b0 + chunk]
        idx_b = idx[b0:b0 + chunk]
        acc = torch.zeros((*tgt_b.shape[:2], 4), dtype=dtype,
                          device=tgt.device)
        comp = torch.zeros_like(acc)
        for s in range(idx.shape[1]):
            ids = idx_b[:, s]
            safe = ids.clamp(min=0).long()
            axes = nodes[safe].transpose(1, 2)               # (bc, n1, 3)
            d = space.displacement(tgt_b[:, :, None, :], axes[:, None])
            dx, dy, dz = d.unbind(-1)                        # (bc, NB, n1)
            r2 = ((dx * dx)[..., :, None, None] + (dy * dy)[..., None, :, None]
                  + (dz * dz)[..., None, None, :])
            g, c = field_coefficients(kernel, r2, params)
            q = qg[safe] * (ids >= 0).to(dtype)[:, None, None, None]
            if magnitude:
                g, c, q = g.abs(), c.abs(), q.abs()
                dx, dy, dz = dx.abs(), dy.abs(), dz.abs()
            q = q[:, None]                                   # over targets
            w = c * q
            rows = w.sum(-1)                                 # (bc, NB, k1, k2)
            f = torch.stack([
                (g * q).sum((-3, -2, -1)),
                (dx * rows.sum(-1)).sum(-1),
                (dy[..., None, :] * rows).sum((-2, -1)),
                (w * dz[..., None, None, :]).sum((-3, -2, -1))], dim=-1)
            if kahan:
                yk = f - comp
                t = acc + yk
                comp = (t - acc) - yk
                acc = t
            else:
                acc = acc + f
        out[b0:b0 + chunk] = acc
    if tgt_count is not None:
        real = (torch.arange(nb, device=out.device)[None, :]
                < tgt_count.to(out.device)[:, None])
        out = torch.where(real[..., None], out, torch.zeros_like(out))
    return out
