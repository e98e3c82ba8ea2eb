"""Runtime checks that cross-check the static pass.

Port of `repro/lint/runtime.py`. Three tools:

- `no_implicit_syncs()`, the counterpart of
  ``jax.transfer_guard("disallow")``: a block in which any implicit host
  sync raises `ImplicitSyncError`. On a CUDA device it holds
  ``torch.cuda.set_sync_debug_mode("error")`` and restores the previous
  mode on exit (the mode is per process). On the CPU, where there is no
  sync to catch, it holds a dispatch mode that raises on the ops that
  WOULD sync on CUDA (``_local_scalar_dense``, ``nonzero``,
  ``masked_select``, ``unique``, ``bincount``, ``equal``, boolean-mask
  indexing) and a function mode that raises on the host pulls that
  never reach the dispatcher on the CPU (``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``np.asarray``): the CPU's own check,
  not a stand-in for the card's. The card always gets the real debug
  mode, so a warm step pays no Python cost per op.
- `explicit_sync(reason)`, the sanctioned pull (the reference's explicit
  ``jax.device_get``): it lifts either guard for its block and counts the
  pull by reason (`sync_counts()`).
- ``REPRO_DEBUG_NANS=1`` (the reference's variable and values):
  `enable_debug_nans_if_requested()` switches on a module-level mode in
  which every `kernels.ops` kernel entry checks its output with
  ``torch.isfinite(out).all()`` inside ``explicit_sync("debug_nans")``
  and raises `FloatingPointError` naming the op (the executor adds the
  lane), and the differentiable executor's backward checks its
  cotangents. `Simulation` and `ServeFrontend` call it from
  ``__init__``. While the mode is off nothing on the path changes.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_DEBUG_NANS_ENV = "REPRO_DEBUG_NANS"

#: The REPRO_DEBUG_NANS mode (read by every kernel entry).
DEBUG_NANS = False

_counts: Dict[str, int] = {}
# CUDA sync debug modes to restore inside explicit_sync, one per active
# CUDA guard (innermost last); CPU guards active; explicit_sync depth.
_cuda_outer: List[int] = []
_cpu_guards = 0
_allowed = 0


class ImplicitSyncError(RuntimeError):
    """An implicit host sync inside `no_implicit_syncs()`."""


# ---------------------------------------------------------------------------
# the CPU half of the guard
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_SYNC_OPS = {
    _aten._local_scalar_dense.default: "a scalar read (.item(), float(t), "
                                       "if t:)",
    _aten.nonzero.default: "nonzero",
    _aten.masked_select.default: "masked_select",
    _aten._unique.default: "unique",
    _aten._unique2.default: "unique",
    _aten.unique_dim.default: "unique",
    _aten.unique_consecutive.default: "unique_consecutive",
    _aten.bincount.default: "bincount",
    _aten.equal.default: "torch.equal",
}
_INDEX_OPS = {_aten.index.Tensor, _aten.index_put_.default,
              _aten.index_put.default, _aten._index_put_impl_.default}
_MASK_DTYPES = (torch.bool, torch.uint8)


def _implicit_sync(func, args) -> Optional[str]:
    """What `func` on `args` would sync for on CUDA, or None."""
    what = _SYNC_OPS.get(func)
    if what is not None:
        return what
    if func in _INDEX_OPS and len(args) > 1 and any(
            isinstance(i, torch.Tensor) and i.dtype in _MASK_DTYPES
            for i in args[1]):
        # a boolean-mask store of one value is a masked_fill: no sync
        if func is not _aten.index.Tensor and len(args) > 2 and \
                isinstance(args[2], torch.Tensor) and args[2].numel() == 1:
            return None
        return "boolean-mask indexing"
    return None


class _CpuSyncGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _allowed:
            what = _implicit_sync(func, args)
            if what is not None:
                raise ImplicitSyncError(
                    f"{what} ({func}) inside no_implicit_syncs() would "
                    f"sync the host with the device on CUDA; wrap a "
                    f"sanctioned pull in explicit_sync(reason)")
        return func(*args, **(kwargs or {}))


_PULLS = {torch.Tensor.tolist: ".tolist()", torch.Tensor.cpu: ".cpu()",
          torch.Tensor.numpy: ".numpy()",
          torch.Tensor.__array__: "np.asarray(tensor)"}


def _to_host(args, kwargs) -> bool:
    """`Tensor.to(...)` arguments that spell out the CPU ("cpu"; a device
    object may be a CUDA one on the card, so it does not count)."""
    return any(isinstance(a, str) and torch.device(a).type == "cpu"
               for a in list(args[1:2]) + [kwargs.get("device")])


class _CpuPullGuard(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _allowed:
            what = _PULLS.get(func)
            if what is None and func is torch.Tensor.to \
                    and _to_host(args, kwargs):
                what = ".to('cpu')"
            if what is not None:
                raise ImplicitSyncError(
                    f"{what} inside no_implicit_syncs() is a device-to-"
                    f"host copy on CUDA; wrap a sanctioned pull in "
                    f"explicit_sync(reason)")
        return func(*args, **kwargs)


# ---------------------------------------------------------------------------
# the guard and the sanctioned pull
# ---------------------------------------------------------------------------


def _is_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def no_implicit_syncs(device=None):
    """Raise `ImplicitSyncError` on an implicit host sync in the block.

    `device`: the device the guarded code runs on (default: CUDA when
    there is one). CUDA holds ``set_sync_debug_mode("error")``; the CPU
    holds the dispatch and function modes (module docstring)."""
    global _cpu_guards
    if _is_cuda(device):
        prev = torch.cuda.get_sync_debug_mode()
        _cuda_outer.append(prev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        except RuntimeError as e:
            if "synchronizing CUDA operation" in str(e) and not isinstance(
                    e, ImplicitSyncError):
                raise ImplicitSyncError(str(e)) from e
            raise
        finally:
            _cuda_outer.pop()
            torch.cuda.set_sync_debug_mode(prev)
        return
    _cpu_guards += 1
    try:
        with _CpuSyncGuard(), _CpuPullGuard():
            yield
    finally:
        _cpu_guards -= 1


@contextlib.contextmanager
def explicit_sync(reason: str):
    """A sanctioned host pull: lift the guard for the block and count it
    under `reason`."""
    global _allowed
    _counts[reason] = _counts.get(reason, 0) + 1
    if not _cuda_outer and not _cpu_guards:
        yield
        return
    _allowed += 1
    prev = None
    if _cuda_outer:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(_cuda_outer[0])
    try:
        yield
    finally:
        _allowed -= 1
        if prev is not None:
            torch.cuda.set_sync_debug_mode(prev)


def sync_counts() -> Dict[str, int]:
    """Explicit pulls by reason so far in this process (callers take
    differences)."""
    return dict(_counts)


# ---------------------------------------------------------------------------
# REPRO_DEBUG_NANS
# ---------------------------------------------------------------------------


def debug_nans_requested() -> bool:
    return os.environ.get(_DEBUG_NANS_ENV, "").strip() in (
        "1", "true", "on", "yes")


def enable_debug_nans_if_requested() -> bool:
    """Turn the mode on when REPRO_DEBUG_NANS asks for it; returns
    whether the variable asked (the reference's contract)."""
    global DEBUG_NANS
    if debug_nans_requested():
        DEBUG_NANS = True
        return True
    return False


def set_debug_nans(on: bool) -> bool:
    """Set the mode; returns the previous setting (tests restore it)."""
    global DEBUG_NANS
    prev, DEBUG_NANS = DEBUG_NANS, bool(on)
    return prev


def check_finite(out: torch.Tensor, op: str) -> torch.Tensor:
    """Raise `FloatingPointError` naming `op` when `out` holds a NaN or
    an infinity (one sanctioned pull); returns `out`."""
    with explicit_sync("debug_nans"):
        ok = bool(torch.isfinite(out).all())
    if not ok:
        raise FloatingPointError(
            f"REPRO_DEBUG_NANS: non-finite output of {op}")
    return out
