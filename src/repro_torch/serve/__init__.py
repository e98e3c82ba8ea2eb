"""Ensemble serving: batched multi-system treecode evaluation (port of
`repro.serve`).

Two layers:

- `EnsemblePlan` / `EnsembleMD` (`repro_torch.serve.batched`): W systems
  padded into one shared `Capacities` budget and stacked along a systems
  axis, one launch per kernel for all of them; plan-protocol compatible.
- `ServeFrontend` (`repro_torch.serve.service`): a request queue that
  buckets systems by shape, packs buckets into fixed-width ensemble
  plans, flushes on size or deadline and returns futures.
"""
from repro_torch.serve.batched import EnsembleMD, EnsemblePlan
from repro_torch.serve.service import (ServeFrontend, ServeFuture,
                                       bucket_key, quantize_points)

__all__ = ["EnsemblePlan", "EnsembleMD", "ServeFrontend", "ServeFuture",
           "bucket_key", "quantize_points"]
