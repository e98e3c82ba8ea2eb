"""O(N^2) direct summation (Eq. 1), the paper's comparison baseline.

PyTorch port of `repro/core/direct.py`:

- `direct_sum`: plain torch, blocked over source chunks so memory stays
  O(NT * chunk); any device and dtype (the f64 reference on the card).
- `direct_oracle_f64`: float64 NumPy (phi and forces), the accuracy
  oracle, copied from the reference.
- `direct_sum_kernel`: ONE batch-cluster kernel launch with one batch of
  all targets and one cluster of all sources, as the paper computes its
  GPU direct sum (Sec. 4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.potentials import Kernel
from repro_torch.core.space import FREE as _FREE
from repro_torch.kernels import ops


def direct_sum(
    targets: torch.Tensor,  # (NT, 3)
    sources: torch.Tensor,  # (NS, 3)
    charges: torch.Tensor,  # (NS,)
    params=None,
    *,
    kernel: Kernel,
    space=_FREE,
    source_chunk: int = 2048,
) -> torch.Tensor:
    """phi (NT,) by blocked direct summation; the i == j singular term is
    excluded by the kernel's r2 > 0 mask (treecode convention)."""
    phi = torch.zeros(targets.shape[0], dtype=targets.dtype,
                      device=targets.device)
    for s in range(0, sources.shape[0], source_chunk):
        g = kernel.pairwise(targets, sources[s:s + source_chunk], params,
                            space)
        phi += g @ charges[s:s + source_chunk]
    return phi


def direct_oracle_f64(points, charges, *, kernel: Kernel, params=None,
                      space=_FREE, chunk: int = 1024):
    """(phi, F) by float64 NumPy direct summation — the accuracy oracle.

    Supports the built-in coulomb/yukawa kernels (the analytic dG/dr2 is
    needed for forces); minimum-image displacements under a periodic
    `space`."""
    x = np.asarray(points, np.float64)
    q = np.asarray(charges, np.float64)
    name = kernel.name
    if name == "yukawa":
        p = kernel.normalize_params(params) if params is not None \
            else kernel.params
        (kappa,) = (float(v) for v in p)
    elif name != "coulomb":
        raise NotImplementedError(
            f"direct_oracle_f64 supports coulomb/yukawa, got {name!r}")
    n = x.shape[0]
    phi = np.zeros(n)
    force = np.zeros((n, 3))
    for s in range(0, n, chunk):
        y = x[s:s + chunk]
        d = x[:, None, :] - y[None, :, :]
        if getattr(space, "periodic", False):
            L = np.asarray(space.lengths)
            d = d - L * np.round(d / L)
        r2 = np.sum(d * d, axis=-1)
        mask = r2 > 0.0
        r2s = np.where(mask, r2, 1.0)
        r = np.sqrt(r2s)
        if name == "coulomb":
            g = 1.0 / r
            dg = -0.5 / (r * r2s)            # dG/dr2 = -1/(2 r^3)
        else:
            e = np.exp(-kappa * r)
            g = e / r
            dg = -0.5 * e * (kappa * r + 1.0) / (r2s * r)
        g = np.where(mask, g, 0.0)
        dg = np.where(mask, dg, 0.0)
        qs = q[s:s + chunk]
        phi += g @ qs
        # grad_i phi = sum_j q_j * 2 * dG/dr2 * d_ij; F_i = -q_i * grad_i
        force += np.einsum("nm,nmd->nd", 2.0 * dg * qs[None, :], d)
    force *= -q[:, None]
    return phi, force


def direct_sum_kernel(
    targets: torch.Tensor,
    sources: torch.Tensor,
    charges: torch.Tensor,
    params=None,
    *,
    kernel: Kernel,
    space=_FREE,
    backend: str = "auto",
) -> torch.Tensor:
    """Direct sum as ONE batch-cluster kernel call (paper's GPU reference):
    one batch = all targets, one cluster = all sources."""
    idx = torch.zeros((1, 1), dtype=torch.int32, device=targets.device)
    phi = ops.batch_cluster_eval(
        idx, targets[None], sources[None], charges[None], params,
        kernel=kernel, space=space, backend=backend)
    return phi[0]
