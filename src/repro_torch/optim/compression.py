"""Int8 gradient compression with error feedback (a trick for
bandwidth-bound data parallelism).

Port of `repro/optim/compression.py`. `compressed_psum` is an all-reduce
over int8 payloads through `torch.distributed`: each rank quantizes its
local gradient to int8 with a per-tensor scale (1 byte an element on the
wire against 4 for an f32 all-reduce), all-gathers the quantized payloads
and the scales, and reduces locally in f32. `ef_quantize` is the
error-feedback loop: the quantization residual is added back into the
next step's gradient (the EF-SGD correction). `torch.round` rounds half
to even, as `jnp.round` does, so the payloads are the reference's.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_quantize(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantization: returns (q, scale, new_err)."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q, scale, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None):
    """Mean over the ranks of `group` (a `torch.distributed` process
    group; None is the default group) of int8-quantized g.

    Wire cost: 1 byte an element (all-gather of int8) + 4 bytes a rank
    (the scale), against 4 bytes an element for an f32 all-reduce.
    Returns (mean_g, new_err)."""
    import torch.distributed as dist

    q, scale, new_err = ef_quantize(g, err)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)            # int8 on the wire
    dist.all_gather(ss, scale.reshape(()), group=group)
    total = torch.tensordot(torch.stack(ss), torch.stack(qs).to(
        torch.float32), dims=([0], [0]))
    return total / n, new_err


def compressed_psum_tree(grads, errs, group=None):
    """`compressed_psum` on every leaf of a tree of dicts: (mean grads,
    new errors), each of the grads' structure."""
    if isinstance(grads, dict):
        parts = {k: compressed_psum_tree(g, errs[k], group)
                 for k, g in grads.items()}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    return compressed_psum(grads, errs, group)
