"""O(N^2) direct summation (Eq. 1), the paper's comparison baseline.

PyTorch port of `repro/core/direct.py`:

- `direct_sum`: plain torch, blocked over source chunks so memory stays
  O(NT * chunk); any device and dtype (the f64 reference on the card).
- `direct_field`: the same for phi and its gradient at the targets (the
  forces reference on the card).
- `direct_oracle_f64`: float64 NumPy (phi and forces), the accuracy
  oracle, copied from the reference.
- `direct_sum_kernel`: ONE batch-cluster kernel launch with one batch of
  all targets and one cluster of all sources, as the paper computes its
  GPU direct sum (Sec. 4).

`direct_field` and `direct_oracle_f64` take any kernel: the analytic G'
of the built-ins (written out here, independent of the kernels' plain
versions), `torch.func.jvp` of `Kernel.__call__` for a user kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.potentials import Kernel, builtin_id
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


def _params(kernel: Kernel, params):
    return kernel.params if params is None \
        else kernel.normalize_params(params)


def _user_g_c(kernel: Kernel, r2: torch.Tensor, params):
    """(G, 2 G') of a user kernel at r2, both 0 where r2 == 0: the JVP of
    the masked `Kernel.__call__` (its double `where` keeps a 0/0 out)."""
    g, dg = torch.func.jvp(lambda t: kernel(t, params), (r2,),
                           (torch.ones_like(r2),))
    return g, 2.0 * dg


def direct_field(
    targets: torch.Tensor,  # (NT, 3)
    sources: torch.Tensor,  # (NS, 3)
    charges: torch.Tensor,  # (NS,)
    params=None,
    *,
    kernel: Kernel,
    space=_FREE,
    source_chunk: int = 2048,
):
    """(phi (NT,), grad (NT, 3)) by blocked direct summation, grad_i =
    sum_j 2 G'(r2) d_ij q_j with d the `space` displacement target minus
    source; exact hits add 0 to both. Forces are -q_i grad_i.

    The forces reference on the card: the built-in coulomb/yukawa
    kernels with G and 2 G' written out here (independent of the field
    kernel's plain version), a user kernel through `torch.func`."""
    kid = builtin_id(kernel)
    p = _params(kernel, params)
    if kid == 1:
        (kappa,) = (float(v) for v in p)
    phi = targets.new_zeros(targets.shape[0])
    grad = targets.new_zeros(targets.shape)
    for s in range(0, sources.shape[0], source_chunk):
        d = space.displacement(targets[:, None, :],
                               sources[None, s:s + source_chunk, :])
        r2 = (d * d).sum(-1)
        if kid is None:
            g, c = _user_g_c(kernel, r2, p)
        else:
            hit = r2 > 0.0
            r = torch.sqrt(torch.where(hit, r2, torch.ones_like(r2)))
            if kid == 0:
                g = 1.0 / r
                c = -g / (r * r)                     # 2 G' = -1/r^3
            else:
                g = torch.exp(-kappa * r) / r
                c = -(1.0 + kappa * r) * g / (r * r)  # 2 G' of e^-kr / r
            zero = torch.zeros_like(r)
            g, c = torch.where(hit, g, zero), torch.where(hit, c, zero)
        qs = charges[s:s + source_chunk]
        phi += g @ qs
        grad += torch.einsum("nm,nmk->nk", c * qs, d)
    return phi, grad


def direct_oracle_f64(points, charges, *, kernel: Kernel, params=None,
                      space=_FREE, chunk: int = 1024):
    """(phi, F) by float64 NumPy direct summation — the accuracy oracle.

    The built-in coulomb/yukawa kernels take their analytic dG/dr2, as
    the reference's; any other kernel its G and dG/dr2 from
    `torch.func.jvp` of `Kernel.__call__` on float64 tensors;
    minimum-image displacements under a periodic `space`."""
    x = np.asarray(points, np.float64)
    q = np.asarray(charges, np.float64)
    kid = builtin_id(kernel)
    p = _params(kernel, params)
    if kid == 1:
        (kappa,) = (float(v) for v in p)
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
        if kid is None:
            g, c = _user_g_c(kernel, torch.from_numpy(r2), p)
            g, dg = g.numpy(), 0.5 * c.numpy()
        else:
            mask = r2 > 0.0
            r2s = np.where(mask, r2, 1.0)
            r = np.sqrt(r2s)
            if kid == 0:
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
