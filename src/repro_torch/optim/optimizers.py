"""Self-contained optimizers: AdamW and Adafactor over the port's
parameter trees (nested dicts of tensors, `models.layers.tree_leaves`
order).

Port of `repro/optim/optimizers.py`, with its functional API:
``state = opt.init(params)`` and ``opt.update(grads, state, params) ->
(params, state, grad_norm)``. Mixed precision as there: params may be
bf16; gradients are cast to f32 inside the update; AdamW moments are f32;
Adafactor keeps factored f32 row/column second-moment statistics for
leaves of two or more dimensions.

The update works IN PLACE under ``torch.no_grad()``: it writes the new
values into the params and moments it was given and returns them (the
reference's launcher donates both, ``donate_argnums=(0, 1)``; a
functional copy of internlm2's f32 moments alone would be 15 GB). The
returned state is a new dict holding the same moment tensors and a new
step. The step is an int32 device scalar; the warmup learning rate and
the bias corrections are computed from it in f32 on the device, so an
update reads nothing to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import (is_dtensor, params_from_numpy,
                                       tree_leaves, tree_map)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in f32: a device scalar."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x, dtype=torch.float32).square()
        for x in tree_leaves(tree)))


def exchanged(grads, params) -> list:
    """The gradient leaves (`tree_leaves` order), each DTensor one
    redistributed to its parameter's placements: a partial sum over the
    data axis is reduced here, once (left partial, each of the update's
    operations on it would reduce it again). Plain tensors pass as they
    are."""
    out = []
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


def _clip_scale(gnorm, max_norm):
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads in f32 scaled to a global norm <= max_norm, global norm).
    The optimizers apply the same scale leaf by leaf inside their update
    instead, so no f32 copy of the whole gradient tree is held."""
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: x.to(torch.float32) * scale, grads), g


def _warm(step, warmup: int):
    return torch.clamp(step / max(warmup, 1), max=1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "step": _step0(params)}

    def _lr(self, step):
        return self.lr * _warm(step + 1, self.warmup)

    @torch.no_grad()
    def update(self, grads, state, params):
        grads = exchanged(grads, params)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.clip_norm)
        step = state["step"] + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        lr = self._lr(step)
        for p, g, m, v in zip(tree_leaves(params), grads,
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = g.to(torch.float32) * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p32 = p.to(torch.float32)
            u = u + self.weight_decay * p32
            p.copy_(p32 - lr * u)     # rounded to p's dtype
        return params, {"m": state["m"], "v": state["v"], "step": step}, \
            gnorm

    def state_logical(self, param_logical):
        """Optimizer-state logical axes (moments shard like their params)."""
        return {"m": param_logical, "v": param_logical, "step": ()}


def _is_fac(x) -> bool:
    return isinstance(x, dict) and ("vr" in x or "v" in x)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.99
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    warmup: int = 100

    def init(self, params):
        def zero_state(p):
            f32, dev = torch.float32, p.device
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                          device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=f32, device=dev)}
            return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}

        return {"fac": tree_map(zero_state, params), "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        grads = exchanged(grads, params)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.clip_norm)
        step = state["step"] + 1
        lr = self.lr * _warm(step, self.warmup)
        d = self.decay
        for p, g, st in zip(tree_leaves(params), grads,
                            tree_leaves(state["fac"], is_leaf=_is_fac)):
            g = g.to(torch.float32) * scale
            g2 = g * g + self.eps
            if p.ndim >= 2:
                vr, vc = st["vr"], st["vc"]
                vr.mul_(d).add_((1 - d) * g2.mean(-1))
                vc.mul_(d).add_((1 - d) * g2.mean(-2))
                denom = (vr / torch.clamp(vr.mean(-1, keepdim=True),
                                          min=self.eps))[..., None] * \
                    vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
            else:
                st["v"].mul_(d).add_((1 - d) * g2)
                u = g * torch.rsqrt(torch.clamp(st["v"], min=self.eps))
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            p32 = p.to(torch.float32)
            if self.weight_decay:
                u = u + self.weight_decay * p32
            p.copy_(p32 - lr * u)     # rounded to p's dtype
        return params, {"fac": state["fac"], "step": step}, gnorm

    def state_logical(self, param_logical):
        def fac_logical(logical):
            if isinstance(logical, dict):
                return {k: fac_logical(v) for k, v in logical.items()}
            if len(logical) >= 2:
                return {"vr": logical[:-1], "vc": logical[:-2] + logical[-1:]}
            return {"v": logical}

        return {"fac": fac_logical(param_logical), "step": ()}


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(name)


def opt_state_from_numpy(tree, device=None):
    """The reference's AdamW ({"m", "v", "step"}) or Adafactor ({"fac",
    "step"}) state as nested dicts of numpy arrays (``jax.tree.map(
    np.asarray, state)``) -> the port's on `device`: the same keys, f32
    moments and an int32 step. With `layers.params_from_numpy` it carries
    a reference run's parameters and optimizer on into the port."""
    if set(tree) not in ({"m", "v", "step"}, {"fac", "step"}):
        raise ValueError(
            f"not an AdamW or Adafactor state: keys {sorted(tree)}")
    out = params_from_numpy(tree, device=device)
    for t in tree_leaves({k: v for k, v in out.items() if k != "step"}):
        if t.dtype != torch.float32:
            raise ValueError(f"optimizer moments must be float32, got "
                             f"{t.dtype}")
    out["step"] = out["step"].to(torch.int32)
    return out
