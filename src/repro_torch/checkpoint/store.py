"""Fault-tolerant checkpointing: atomic, asynchronous, elastic.

Port of `repro/checkpoint/store.py`, with its on-disk layout, so a
checkpoint written by the reference restores here (and back):

    <dir>/step_<k>/  one .npy per leaf (numbered) + manifest.json

  - ATOMIC: written into step_<k>.tmp, then os.replace'd: a crash
    mid-save never corrupts the latest checkpoint;
  - ASYNC: `save(..., background=True)` copies every tensor to host
    memory first (the one device wait of a save), then writes from a
    thread, keeping serialization off the step loop;
  - ELASTIC: a leaf is stored whole. A DTensor leaf is gathered
    (`full_tensor`, a collective every rank of its mesh joins), and in a
    process group rank 0 alone writes; `restore` places each leaf by
    target shardings (DTensor placements) or like `like`'s DTensor
    leaves, so a checkpoint written on one mesh restores on any other
    mesh or on one device.

Leaves are keyed by their path in the tree, the reference's naming:
dict keys and namedtuple fields by name, sequence items by index,
joined with "::".
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_SEP = "::"


def _flatten(tree, prefix=(), is_leaf=lambda t: False):
    """{path key: leaf} in tree order (None is a leaf; so is anything
    `is_leaf` takes)."""
    if is_leaf(tree):
        return {_SEP.join(prefix): tree}
    if isinstance(tree, dict):
        items = {}
        for k in sorted(tree):
            items.update(_flatten(tree[k], prefix + (str(k),), is_leaf))
        return items
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = {}
        for k in tree._fields:
            items.update(_flatten(getattr(tree, k), prefix + (k,), is_leaf))
        return items
    if isinstance(tree, (list, tuple)):
        items = {}
        for i, v in enumerate(tree):
            items.update(_flatten(v, prefix + (str(i),), is_leaf))
        return items
    return {_SEP.join(prefix): tree}


def _is_sharding(t) -> bool:
    """A leaf of a shardings tree: a tuple of DTensor placements or a
    resolved spec (mesh axis names, tuples of them, None)."""
    return isinstance(t, tuple) and all(
        hasattr(e, "is_shard") or e is None or isinstance(e, (str, tuple))
        for e in t)


def _unflatten(like, items, prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, items, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, k), items,
                                       prefix + (k,)) for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, items, prefix + (str(i),))
                          for i, v in enumerate(like))
    return items[_SEP.join(prefix)]


def _is_dtensor(v) -> bool:
    return getattr(v, "device_mesh", None) is not None


def _writer() -> bool:
    """Whether this process writes: rank 0 of the default process group,
    or a process without one."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _host(v) -> np.ndarray:
    """A host copy of a leaf: the caller may go on updating the tensor in
    place (an optimizer step) while a background save writes it."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        elif v.device.type == "cpu":
            v = v.clone()      # .numpy() of a CPU tensor shares its memory
        return v.cpu().numpy()
    return np.asarray(v)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _write(ckpt_dir: str, step: int, host_items: dict, meta: dict,
           keep_last: int):
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta, "leaves": {}}
    # Leaf files are numbered; restore resolves names through the
    # manifest.
    for i, (key, arr) in enumerate(host_items.items()):
        fname = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


class Checkpointer:
    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             background: bool = True):
        """Write `tree` as step `step`. Every rank of a process group
        calls it (a DTensor leaf is gathered on the calling thread, leaf
        by leaf); rank 0 alone writes, and removes all but the last
        `keep_last` steps."""
        self.wait()  # at most one in-flight save
        writer = _writer()
        host_items = {}
        for k, v in _flatten(tree).items():
            if _is_dtensor(v):
                v = v.full_tensor()
            if writer:
                host_items[k] = _host(v)
        if not writer:
            return
        args = (self.dir, step, host_items, meta or {}, self.keep_last)
        if background:
            self._thread = threading.Thread(target=_write, args=args,
                                            daemon=True)
            self._thread.start()
        else:
            _write(*args)

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None, *, mesh=None):
        """Restore into the structure of `like`: returns (tree, step,
        meta). A tensor leaf of `like` gives a tensor of its dtype on its
        device; any other leaf (None included) the stored array as it is.

        Elastic restart across meshes and device counts: where
        `shardings` (a tree of `like`'s structure, as
        `models.config.make_shardings` returns it) gives a leaf DTensor
        placements, the leaf becomes a DTensor over `mesh` (default: the
        mesh of `like`'s DTensor leaves) with those placements; else a
        DTensor leaf of `like` gives one of its mesh and placements. Every
        rank reads the whole leaf and keeps its own shard (no collective).
        A resolved spec (a mesh of one device) places nothing."""
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        refs = _flatten(like)
        places = (_flatten(shardings, is_leaf=_is_sharding)
                  if shardings is not None else {})
        if mesh is None:
            mesh = next((r.device_mesh for r in refs.values()
                         if _is_dtensor(r)), None)
        out = {}
        for key, ref in refs.items():
            entry = manifest["leaves"][key]
            arr = np.load(os.path.join(d, entry["file"]))
            on, pl = None, places.get(key)
            if pl is not None and len(pl) and hasattr(pl[0], "is_shard"):
                if mesh is None:
                    raise ValueError(f"{key}: placements {pl} need a mesh "
                                     f"(pass mesh= or DTensor leaves)")
                on = mesh
            elif _is_dtensor(ref):
                on, pl = ref.device_mesh, ref.placements
            if isinstance(ref, torch.Tensor):
                arr = torch.as_tensor(arr).to(device=ref.device,
                                              dtype=ref.dtype)
            if on is not None:
                from torch.distributed.tensor import distribute_tensor
                arr = distribute_tensor(torch.as_tensor(arr), on, pl,
                                        src_data_rank=None)
            out[key] = arr
        return _unflatten(like, out), step, manifest["meta"]

    def maybe_restore(self, like: Any, step: Optional[int] = None,
                      shardings: Any = None, *, mesh=None):
        """`restore`, but None instead of raising when no checkpoint
        exists (the resume-or-start idiom of long-running MD drivers)."""
        if (step if step is not None else latest_step(self.dir)) is None:
            return None
        return self.restore(like, step=step, shardings=shardings,
                            mesh=mesh)
