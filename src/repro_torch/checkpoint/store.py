"""Fault-tolerant checkpointing: atomic and asynchronous.

Port of `repro/checkpoint/store.py`, with its on-disk layout, so a
checkpoint written by the reference restores here (and back):

    <dir>/step_<k>/  one .npy per leaf (numbered) + manifest.json

  - ATOMIC: written into step_<k>.tmp, then os.replace'd: a crash
    mid-save never corrupts the latest checkpoint;
  - ASYNC: `save(..., background=True)` copies every tensor to host
    memory first (the one device wait of a save), then writes from a
    thread, keeping serialization off the step loop.

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


def _flatten(tree, prefix=()):
    """{path key: leaf} in tree order (None is a leaf)."""
    if isinstance(tree, dict):
        items = {}
        for k in sorted(tree):
            items.update(_flatten(tree[k], prefix + (str(k),)))
        return items
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = {}
        for k in tree._fields:
            items.update(_flatten(getattr(tree, k), prefix + (k,)))
        return items
    if isinstance(tree, (list, tuple)):
        items = {}
        for i, v in enumerate(tree):
            items.update(_flatten(v, prefix + (str(i),)))
        return items
    return {_SEP.join(prefix): tree}


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
        self.wait()  # at most one in-flight save
        host_items = {k: _host(v) for k, v in _flatten(tree).items()}
        args = (self.dir, step, host_items, meta or {}, self.keep_last)
        if background:
            self._thread = threading.Thread(target=_write, args=args,
                                            daemon=True)
            self._thread.start()
        else:
            _write(*args)

    def restore(self, like: Any, step: Optional[int] = None):
        """Restore into the structure of `like`: returns (tree, step,
        meta). A tensor leaf of `like` gives a tensor of its dtype on its
        device; any other leaf (None included) the stored array as it
        is."""
        step = step if step is not None else latest_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for key, ref in _flatten(like).items():
            entry = manifest["leaves"][key]
            arr = np.load(os.path.join(d, entry["file"]))
            if isinstance(ref, torch.Tensor):
                arr = torch.as_tensor(arr).to(device=ref.device,
                                              dtype=ref.dtype)
            out[key] = arr
        return _unflatten(like, out), step, manifest["meta"]

    def maybe_restore(self, like: Any, step: Optional[int] = None):
        """`restore`, but None instead of raising when no checkpoint
        exists (the resume-or-start idiom of long-running MD drivers)."""
        if (step if step is not None else latest_step(self.dir)) is None:
            return None
        return self.restore(like, step=step)
