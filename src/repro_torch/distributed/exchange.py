"""The sharded executor's two collectives, over where the ranks live.

The reference runs its sharded program under `shard_map` with two
collectives (`repro/distributed/bltc.py`): an all-gather of every rank's
node boxes and modified charges (the LET's phase 1), and rounds of
`collective_permute` that hand boundary leaves to the ranks at a fixed
offset (phase 2). The port's executor is written once over a leading
local-rank axis R and calls them through this interface:

  all_gather(t)              (R, ...) -> (P, ...), rank order
  halo_round(tensors, off)   rank r receives the rows rank r - off sent,
                             zeros where no such rank exists
  all_min(t)                 the minimum over every rank
  local(a)                   the rows of a stacked (P, ...) host array
                             this process keeps

`StackedRanks` keeps every rank on one device (R = P, every collective
an index operation); `GroupRanks` runs one rank per process over a 1-D
`torch.distributed` device mesh (R = 1; gloo on CPU tensors, NCCL on
CUDA tensors). Neither falls back to the other.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class StackedRanks:
    """All P ranks on one device, as the leading axis of every array."""

    def __init__(self, nranks: int):
        self.nranks = int(nranks)

    def __repr__(self) -> str:
        return f"StackedRanks({self.nranks})"

    @property
    def first_rank(self) -> int:
        return 0

    def local(self, a: np.ndarray) -> np.ndarray:
        return a

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def halo_round(self, tensors: Sequence[torch.Tensor],
                   off: int) -> list:
        out = []
        for t in tensors:
            r = torch.zeros_like(t)
            if 0 < off < self.nranks:
                r[off:] = t[:-off]
            elif -self.nranks < off < 0:
                r[:off] = t[-off:]
            out.append(r)
        return out

    def all_min(self, t: torch.Tensor) -> torch.Tensor:
        return t


class GroupRanks:
    """One rank per process over a 1-D `DeviceMesh` (the reference's
    ``mesh=``): every process holds its own row of each stacked array."""

    def __init__(self, mesh):
        if mesh.ndim != 1:
            raise ValueError(
                f"sharded plans shard over exactly one mesh dimension; got "
                f"{mesh.ndim}")
        import torch.distributed as dist
        self._dist = dist
        self.mesh = mesh
        self.group = mesh.get_group()
        self.nranks = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def __repr__(self) -> str:
        return f"GroupRanks(rank {self.rank} of {self.nranks})"

    @property
    def first_rank(self) -> int:
        return self.rank

    def local(self, a: np.ndarray) -> np.ndarray:
        return a[self.rank:self.rank + 1]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = t.new_empty((self.nranks * t.shape[0],) + tuple(t.shape[1:]))
        self._dist.all_gather_into_tensor(out, t.contiguous(),
                                          group=self.group)
        return out

    def halo_round(self, tensors: Sequence[torch.Tensor],
                   off: int) -> list:
        dist = self._dist
        recv = [torch.zeros_like(t) for t in tensors]
        ops = []
        for peer, op, bufs in ((self.rank + off, dist.isend,
                                [t.contiguous() for t in tensors]),
                               (self.rank - off, dist.irecv, recv)):
            if 0 <= peer < self.nranks:
                g = dist.get_global_rank(self.group, peer)
                ops += [dist.P2POp(op, b, g, self.group, tag=i)
                        for i, b in enumerate(bufs)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return recv

    def all_min(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MIN,
                              group=self.group)
        return t
