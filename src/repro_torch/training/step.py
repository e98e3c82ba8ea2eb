"""Train step, eval step and straggler watchdog, family-agnostic (built on
`models.api.Model`).

Port of `repro/training/step.py`. `loss_and_grads` is the gradient as a
plain function (the reference's ``jax.value_and_grad(model.loss,
has_aux=True)``): `torch.autograd.grad` of the loss over detached,
grad-requiring aliases of the parameter leaves (views of the same
storage, no copy); each grad comes back in its param's dtype. The train
step updates the params and the optimizer state in place (the
reference's launcher donates both) and returns the metrics as device
tensors: a step reads nothing to the host.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.models.api import Model
from repro_torch.models.config import NO_SHARD, ShardCtx
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim.optimizers import global_norm


def _rebuild(tree, leaves):
    """`tree` with its leaves (in `tree_leaves` order) replaced."""
    it = iter(leaves)
    order = {id(t): next(it) for t in tree_leaves(tree)}
    return tree_map(lambda t: order[id(t)], tree)


def loss_and_grads(model: Model, params, batch, ctx: ShardCtx = NO_SHARD):
    """((loss, metrics), grads) of `model.loss` at `params`: the loss a
    device scalar, the metrics detached, the grads a tree of `params`'
    structure, each leaf in its param's dtype (a param the loss does not
    reach gets zeros)."""
    leaves = tree_leaves(params)
    inputs = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss(_rebuild(params, inputs), batch, ctx)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _rebuild(params, grads)


def _micro(batch, accum: int, i: int):
    """Microbatch i of `accum` along the leading (batch) axis."""
    def part(x):
        n = x.shape[0] // accum
        return x[i * n:(i + 1) * n]
    return {k: part(v) for k, v in batch.items()}


def make_train_step(model: Model, opt, ctx: ShardCtx = NO_SHARD) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With cfg.grad_accum > 1 the global batch is split into microbatches
    run in turn; their gradients are summed in f32 and averaged before the
    optimizer update (the reference's scan): activation memory scales
    down by the accumulation factor. The params and the moments are
    updated in place; metrics loss, grad_norm and param_norm are device
    scalars."""
    accum = max(1, model.cfg.grad_accum)

    def train_step(params, opt_state, batch):
        if accum == 1:
            (loss, metrics), grads = loss_and_grads(model, params, batch, ctx)
        else:
            gsum, lsum = None, None
            for i in range(accum):
                (l, _), g = loss_and_grads(model, params,
                                           _micro(batch, accum, i), ctx)
                g = tree_map(lambda x: x.to(torch.float32), g)
                if gsum is None:
                    gsum, lsum = g, l
                else:
                    for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                        a.add_(b)
                    lsum = lsum + l
                del g
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            metrics = {"loss": loss}
        new_params, new_state, gnorm = opt.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       param_norm=global_norm(new_params))
        return new_params, new_state, metrics

    return train_step


def make_eval_step(model: Model, ctx: ShardCtx = NO_SHARD) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch, ctx)
        return dict(metrics, loss=loss)

    return eval_step


class StepWatchdog:
    """Straggler/hang detection: tracks a running step-time estimate and
    flags steps slower than `factor` x the median of recent steps. At
    multi-host scale the flag would feed a restart policy; here it
    surfaces in the launcher's log (and is unit-tested)."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.times: list = []
        self.window = window
        self._t0: Optional[float] = None
        self.flagged = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        dt = time.monotonic() - self._t0
        slow = False
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.factor * med
            if slow:
                self.flagged += 1
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return slow
