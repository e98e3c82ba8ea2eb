"""repro_torch.lint — host-sync & device-residency checks for the port.

Port of `repro.lint`, in PyTorch's terms (README, "Checking tools"):

- `resolver`: indexes every function of the scanned files, marks the
  port's steady entry points (`HOT_ROOTS`) hot and closes over a
  best-effort call graph (closures, ``self.m``, module aliases,
  specific method names).
- `rules`: host pulls, implicit scalar reads and data-dependent shapes
  in hot functions (HS001-HS003), prints and nondeterminism there
  (TS006, ND001), device waits outside an obs gate (OB001), and the
  devtree contract (DV001, DV002).
- `cli`: ``python -m repro_torch.lint [paths] [--format gh|json]
  [--list-hot] [--baseline ...]``, the reference's exit codes and
  suppression syntax (``# lint: disable=RULE — reason``); the baseline
  scope is empty, so the port is held to zero findings.
- `runtime`: the dynamic half. ``no_implicit_syncs()`` holds
  ``torch.cuda.set_sync_debug_mode("error")`` on the card (a dispatch
  mode on the CPU), ``explicit_sync(reason)`` is the sanctioned pull it
  counts, and ``REPRO_DEBUG_NANS=1`` checks every kernel entry's output.
"""
from repro_torch.lint.findings import Finding, Severity
from repro_torch.lint.resolver import HOT_ROOTS, HotResolver, scan_paths
from repro_torch.lint.rules import ALL_RULES, get_rule, run_rules
from repro_torch.lint.baseline import (BASELINE_SCOPE, load_baseline,
                                       write_baseline, apply_baseline)
from repro_torch.lint.cli import lint, main

__all__ = [
    "Finding", "Severity", "HOT_ROOTS", "HotResolver", "scan_paths",
    "ALL_RULES", "get_rule", "run_rules",
    "BASELINE_SCOPE", "load_baseline", "write_baseline", "apply_baseline",
    "lint", "main",
]
