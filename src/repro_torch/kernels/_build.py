"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` into its own shared library with a plain
C interface, loaded with `ctypes` (no PyTorch headers, so a build takes
seconds, not minutes). Builds happen at first use, into
``<repo>/build/kernels/`` (git-ignored; ``REPRO_TORCH_BUILD_DIR``
overrides it), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is reused. `build()` starts one
`nvcc` per source, all at once, and waits for them together.

A *user library* is a batch-cluster source built for a user kernel: the
same source with ``-DREPRO_USER_KERNEL`` and ``-include`` of the header
`kernels.codegen` generated from the kernel's torch function, plus any
``-D`` `defines` (the grid field kernel's degree). Its name hashes the
generated header and the defines too, so two kernels with one generated
text share it. It builds at first use like the others, each build an
event of `repro_torch.obs.events`; its key in `BUILD_SECONDS`,
`BUILD_LOG` and the loaded libraries is `label(name, header, defines)`.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.obs import events as _events

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("batch_cluster", "batch_cluster_field", "batch_cluster_field_grid",
           "modified_charges")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Seconds from the start of its `build` call to the end of each library's
#: nvcc in this process (0.0: reused); the builds of a call run together.
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


def _digest(data: bytes, n: int = 16) -> str:
    return hashlib.sha256(data).hexdigest()[:n]


def _user_flags(header: Optional[str], defines: Tuple[str, ...]) -> tuple:
    """The flags a user library adds (the header's path comes apart)."""
    return ((("-DREPRO_USER_KERNEL",) if header is not None else ())
            + tuple(f"-D{d}" for d in defines))


def label(name: str, header: Optional[str] = None,
          defines: Tuple[str, ...] = ()) -> str:
    """The key of a library: the source's name, and for a user library
    the generated header's digest and the defines after it."""
    if header is None and not defines:
        return name
    if header is not None:
        name = f"{name}:user_{_digest(header.encode(), 8)}"
    return ":".join((name,) + tuple(defines))


def library_path(name: str, header: Optional[str] = None,
                 defines: Tuple[str, ...] = ()) -> Path:
    """Where the library of source `name` (with a generated `header` and
    `defines`, for a user library) is built: named by their hash."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    if header is not None:
        src += header.encode()
    flags = NVCC_FLAGS + _user_flags(header, tuple(defines))
    h = _digest(src + " ".join(flags).encode())
    return build_dir() / f"lib{name}_{h}.so"


def _spec(entry) -> Tuple[str, Optional[str], Tuple[str, ...]]:
    if isinstance(entry, str):
        return entry, None, ()
    name, header, defines = entry
    return name, header, tuple(defines)


def _finish(proc) -> Tuple[str, float]:
    """(nvcc's output, the moment it ended) of a started build."""
    log, _ = proc.communicate()
    return log, time.perf_counter()


def build(names: Optional[Iterable] = None) -> Dict[str, Path]:
    """Compile the named libraries (default: every source) that are not
    built yet. An entry is a source's name or, for a user library, a
    (name, generated header, defines) triple.

    All missing libraries compile concurrently; raises RuntimeError with
    nvcc's output if any fails. Returns {label: library path}."""
    specs = [_spec(e) for e in (SOURCES if names is None else names)]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {label(*sp): library_path(*sp) for sp in specs}
    procs = {}
    t0 = time.perf_counter()
    for (name, header, defines), (key, path) in zip(specs, paths.items()):
        if path.exists() or key in procs:
            BUILD_SECONDS.setdefault(key, 0.0)
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        include = ()
        if header is not None:
            hdr = out_dir / f"user_{_digest(header.encode())}.h"
            if not hdr.exists():
                hdr_tmp = hdr.with_suffix(f".{os.getpid()}.tmp")
                hdr_tmp.write_text(header)
                os.replace(hdr_tmp, hdr)
            include = ("-include", str(hdr))
        cmd = [find_nvcc(), *NVCC_FLAGS, *_user_flags(header, defines),
               *include, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, name)
    # each nvcc's output drained, and its end timed, on a thread of its own
    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        done = {key: pool.submit(_finish, proc) for key, (proc, _, _)
                in procs.items()}
    errors = []
    for key, (proc, tmp, name) in procs.items():
        log, end = done[key].result()
        BUILD_SECONDS[key] = end - t0
        BUILD_LOG[key] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu ({key}):\n{log}")
            continue
        os.replace(tmp, paths[key])  # atomic: concurrent builders agree
        _events.record_build(key, BUILD_SECONDS[key] * 1e3)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, signatures: Dict[str, tuple],
         header: Optional[str] = None,
         defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library `name` (a user library with a generated `header`
    and `defines`), built first if needed, with `argtypes` set from
    `signatures` ({function: argtypes}); every entry returns an int
    (cudaGetLastError() after its launches)."""
    key = label(name, header, defines)
    lib = _LIBS.get(key)
    if lib is None:
        path = build([(name, header, defines)])[key]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[key] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
