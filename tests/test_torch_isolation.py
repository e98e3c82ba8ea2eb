"""repro_torch stands alone: it imports neither jax nor any repro module."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
MODULES = ["repro_torch.core.api", "repro_torch.core.eval",
           "repro_torch.core.direct",
           "repro_torch.configs.bltc", "repro_torch.obs",
           "repro_torch.kernels.ops", "repro_torch.kernels.ref",
           "repro_torch.dynamics", "repro_torch.checkpoint.store",
           "repro_torch.devtree", "repro_torch.devtree.morton",
           "repro_torch.devtree.lists", "repro_torch.serve",
           "repro_torch.launch.serve", "repro_torch.distributed",
           "repro_torch.distributed.rcb", "repro_torch.distributed.bltc",
           "repro_torch.distributed.exchange", "repro_torch.lint",
           "repro_torch.lint.runtime", "repro_torch.lint.cli",
           "repro_torch.obs.transfers", "repro_torch.launch.dryrun_bltc",
           "repro_torch.configs.registry", "repro_torch.models.config",
           "repro_torch.models.layers", "repro_torch.models.moe",
           "repro_torch.models.transformer", "repro_torch.models.mamba2",
           "repro_torch.models.whisper", "repro_torch.models.llava",
           "repro_torch.models.api", "repro_torch.optim.optimizers",
           "repro_torch.optim.compression", "repro_torch.data.pipeline",
           "repro_torch.training.step", "repro_torch.launch.mesh",
           "repro_torch.launch.train", "repro_torch.launch.dryrun",
           "repro_torch.launch.hlo_analysis", "repro_torch.obs.report"]


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax_and_no_repro(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]


def test_no_source_names_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s))", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 15
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not pattern.search(smoke)


def test_cuda_sources_are_present():
    csrc = os.path.join(PKG, "kernels", "csrc")
    names = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert names == ["batch_cluster.cu", "batch_cluster_field.cu",
                     "batch_cluster_field_grid.cu", "modified_charges.cu"]
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert headers == ["field_common.cuh"]
    for name in names + headers:
        text = open(os.path.join(csrc, name)).read()
        if name in names:
            assert 'extern "C"' in text and "cudaGetLastError" in text
        text = re.sub(r"//.*", "", text)                # the code only
        # IEEE division and exp, and no approximate intrinsic but the one
        # f32 reciprocal square root of the batch-cluster and field pairs
        # (MUFU.RSQ, within 2 ulp; f64 keeps the IEEE 1/sqrt), written
        # once for the potential and once for both field kernels
        assert not re.search(r"\b(rsqrtf?|__fdividef|__expf)\s*\(", text)
        assert text.count("rsqrt.approx") == (
            name in ("batch_cluster.cu", "field_common.cuh"))
        # the three batch-cluster sources share the kernel ids, the
        # parameters and the user-kernel hook of field_common.cuh
        assert ('#include "field_common.cuh"' in text) == (
            name.startswith("batch_cluster"))
    # ... nor in a user library's generated header, whose -1/2 and -3/2
    # powers and rsqrt are IEEE 1 / sqrt in both precisions
    import torch
    from repro_torch.core.potentials import Kernel, kernel_source
    for of_r2 in (lambda r2, p: (r2 + p[0]) ** -0.5,
                  lambda r2, p: torch.rsqrt(r2 + p[0]) * torch.exp(-r2)):
        text = re.sub(r"//.*", "", kernel_source(
            Kernel("user", of_r2, (1e-4,), ("eps2",))).text)
        assert not re.search(r"\b(rsqrtf?|__fdividef|__expf)\s*\(", text)
        assert "rsqrt" not in text and ".approx" not in text
    from repro_torch.kernels import _build
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)


TWINS = ["quickstart_torch.py", "figure4_sweep_torch.py", "md_nbody_torch.py",
         "train_lm_torch.py"]
# what an example twin may import: the port, torch, numpy, the stdlib
TWIN_IMPORTS = {"repro_torch", "torch", "numpy", "argparse", "collections",
                "dataclasses", "os", "tempfile", "time"}


@pytest.mark.parametrize("name", TWINS)
def test_example_twin_imports_only_the_port_torch_and_numpy(name):
    text = open(os.path.join(ROOT, "examples", name)).read()
    mods = re.findall(r"^\s*(?:import\s+([\w.]+)|from\s+([\w.]+)\s+import)",
                      text, re.M)
    tops = {(a or b).split(".")[0] for a, b in mods}
    assert "repro_torch" in tops and not tops - TWIN_IMPORTS, tops
