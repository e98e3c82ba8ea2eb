"""repro_torch stands alone: it imports neither jax nor any repro module."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
MODULES = ["repro_torch.core.api", "repro_torch.core.direct",
           "repro_torch.configs.bltc", "repro_torch.obs",
           "repro_torch.kernels.ops", "repro_torch.kernels.ref"]


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
    assert names == ["batch_cluster.cu", "modified_charges.cu"]
    for name in names:
        text = open(os.path.join(csrc, name)).read()
        assert 'extern "C"' in text and "cudaGetLastError" in text
        # IEEE 1/sqrt and division: no approximate intrinsics
        assert not re.search(r"\b(rsqrtf?|__fdividef|__expf)\s*\(", text)
