"""Device-resident tree pipeline: Morton build + on-device lists.

Port of `repro/devtree`. `repro_torch.devtree` builds a complete treecode
plan on the plan's device: a Morton (Z-order) radix ordering of the
particles (`morton`), a fixed-depth budgeted hybrid octree from the
sorted codes (`build`), and a level-synchronous interaction-list
traversal (`lists`), all in PyTorch tensor ops (sorts, searches, cumsums
and integer or min/max scatters) with no data-dependent shape. The
output is an ordinary `repro_torch.core.eval.Plan`, the same `arrays`
schema and `Capacities` contract as the host build, so the executors,
the refit and the MD engine take it unchanged. Selected with
``TreecodeConfig(build_backend="device")``.
"""
from repro_torch.devtree.build import (  # noqa: F401
    PendingDevicePlan, dispatch_plan_device, prepare_plan_device)
