"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` into its own shared library with a plain
C interface, loaded with `ctypes` (no PyTorch headers, so a build takes
seconds, not minutes). Builds happen at first use, into
``<repo>/build/kernels/`` (git-ignored; ``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused. `build()` starts one
`nvcc` per source, all at once, and waits for them together.

No ``--use_fast_math``: the f64 bar is 1e-12 and the exact-hit compare in
the modified charges needs IEEE arithmetic. ``-Xptxas -v`` makes nvcc
report registers, shared memory and spills per kernel; the report of a
build is kept in `BUILD_LOG`, and each build is an event of
`repro_torch.obs.events` (what the MD engine counts as a compile).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from repro_torch.obs import events as _events

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("batch_cluster", "batch_cluster_field", "batch_cluster_field_grid",
           "modified_charges")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Seconds each library took to build in this process (0.0: reused).
BUILD_SECONDS: Dict[str, float] = {}
#: nvcc's output (the ptxas report) per library built in this process.
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch "
        "build from source at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet.

    All missing libraries compile concurrently; raises RuntimeError with
    nvcc's output if any fails. Returns {name: library path}."""
    names = tuple(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, path in paths.items():
        if path.exists():
            BUILD_SECONDS.setdefault(n, 0.0)
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        os.replace(tmp, paths[n])  # atomic: concurrent builders agree
        _events.record_build(n, BUILD_SECONDS[n] * 1e3)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, with `argtypes`
    set from `signatures` ({function: argtypes}); every entry returns
    an int (cudaGetLastError() after its launches)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
