"""The CUDA code generated from a user kernel's torch function
(`repro_torch.kernels.codegen`), on the CPU.

The generated header is host-and-device code (``REPRO_HD``), so g++ builds
the very text the card's user libraries are built with: one shared
library for every test kernel (one translation unit each, the functions in
an anonymous namespace), called through ctypes and held against `of_r2`
and `torch.func.jvp` of it. Also the refusals (an op outside the
whitelist, Python control flow on a parameter, a captured tensor) and the
cache key of a user library (`_build.library_path`, no nvcc)."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core.potentials import Kernel, kernel_source
from repro_torch.kernels import _build
from repro_torch.kernels import codegen


def _coulomb_user(r2, params):
    return torch.reciprocal(torch.sqrt(r2))


def _yukawa_user(r2, params):
    (kappa,) = params
    r = torch.sqrt(r2)
    return torch.exp(-kappa * r) / r


def _gauss(r2, params):                  # tests/test_api.py's Gaussian
    (alpha,) = params
    return torch.exp(-alpha * r2)


def _inv_quad(r2, params):               # tests/test_api.py's 1/(1+r2)
    return 1.0 / (1.0 + r2)


def _stretched(r2, params):              # tests/test_periodic.py's r^-alpha
    (alpha,) = params
    return torch.reciprocal(torch.sqrt(r2)) ** alpha


def _plummer(r2, params):
    (eps2,) = params
    return (r2 + eps2) ** -0.5


def _cutoff(r2, params):                 # a kernel with torch.where
    (rc2,) = params
    inner = torch.where(r2 < rc2, 1.0 - r2 / rc2, torch.zeros_like(r2))
    return inner * inner + torch.rsqrt(r2)


KERNELS = {
    "coulomb_user": Kernel("coulomb_user", _coulomb_user),
    "yukawa_user": Kernel("yukawa_user", _yukawa_user, (0.7,), ("kappa",)),
    "gaussian": Kernel("gaussian_test", _gauss, (2.0,)),
    "inv_quad": Kernel("inv_quad_test", _inv_quad),
    "stretched": Kernel("stretched_coulomb_test", _stretched, (2.0,),
                        ("alpha",)),
    "plummer": Kernel("plummer", _plummer, (1e-2,), ("eps2",)),
    "cutoff": Kernel("cutoff", _cutoff, (0.5,), ("rc2",)),
}
#: f32: a few ulp of the value, against torch's own f32 arithmetic.
F32_RTOL = 8 * float(np.finfo(np.float32).eps)
F64_RTOL = 1e-13
R2 = np.logspace(-6, 3, 241)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """One g++ build of every test kernel's generated header: entries
    `<name>_gc_f64` / `_f32` (g and c over an array of r2) and
    `<name>_g_f64` (g alone)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler (g++) to build the generated code")
    d = tmp_path_factory.mktemp("codegen")
    units = []
    for name, kern in KERNELS.items():
        (d / f"{name}.h").write_text(kernel_source(kern).text)
        unit = d / f"{name}.cpp"
        unit.write_text(f'''#include "{name}.h"
extern "C" {{
void {name}_gc_f64(const double* r2, const double* p, double* g,
                   double* c, int n) {{
  for (int i = 0; i < n; ++i) repro_user_gc<double>(r2[i], p, g + i, c + i);
}}
void {name}_gc_f32(const float* r2, const float* p, float* g, float* c,
                   int n) {{
  for (int i = 0; i < n; ++i) repro_user_gc<float>(r2[i], p, g + i, c + i);
}}
void {name}_g_f64(const double* r2, const double* p, double* g, int n) {{
  for (int i = 0; i < n; ++i) g[i] = repro_user_g<double>(r2[i], p);
}}
}}
''')
        units.append(str(unit))
    lib = d / "libgenerated.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib), *units], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _generated(lib, name, dtype):
    """(g, c) of the generated code on R2 in `dtype`."""
    kern = KERNELS[name]
    r2 = R2.astype(dtype)
    p = np.array(kern.params or (0.0,), dtype)
    g, c = np.zeros_like(r2), np.zeros_like(r2)
    suffix = "f64" if dtype == np.float64 else "f32"
    getattr(lib, f"{name}_gc_{suffix}")(_ptr(r2), _ptr(p), _ptr(g), _ptr(c),
                                        ctypes.c_int(r2.size))
    return g, c


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(KERNELS))
def test_generated_matches_torch(host_lib, name, dtype):
    """G and 2 G' of the generated code against `of_r2` and
    `torch.func.jvp` of it, on a log-spaced r2 grid: f64 rtol 1e-13, f32
    a few ulp."""
    kern = KERNELS[name]
    g, c = _generated(host_lib, name, dtype)
    r2 = torch.as_tensor(R2.astype(dtype))
    params = tuple(torch.tensor(v, dtype=r2.dtype) for v in kern.params)
    want_g, dg = torch.func.jvp(lambda t: kern.of_r2(t, params), (r2,),
                                (torch.ones_like(r2),))
    rtol = F64_RTOL if dtype == np.float64 else F32_RTOL
    np.testing.assert_allclose(g, want_g.numpy(), rtol=rtol, atol=0)
    np.testing.assert_allclose(c, 2.0 * dg.numpy(), rtol=rtol, atol=0)
    if dtype == np.float64:
        p = np.array(kern.params or (0.0,))
        g_only = np.zeros_like(R2)
        getattr(host_lib, f"{name}_g_f64")(_ptr(R2), _ptr(p), _ptr(g_only),
                                           ctypes.c_int(R2.size))
        np.testing.assert_array_equal(g_only, g)


@pytest.mark.parametrize("name", ["coulomb_user", "yukawa_user"])
def test_generated_matches_hand_written(host_lib, name):
    """Coulomb and Yukawa written as user functions against the built-ins'
    hand-written f64 formulas in `csrc/batch_cluster*.cu`: G = 1/r, 2 G'
    = -G / r2; G = e^(-kappa r) / r, 2 G' = -(1 + kappa r) G / r2."""
    g, c = _generated(host_lib, name, np.float64)
    r = np.sqrt(R2)
    if name == "coulomb_user":
        want_g = 1.0 / r
        want_c = -want_g * (1.0 / r) ** 2
    else:
        (kappa,) = KERNELS[name].params
        want_g = np.exp(-kappa * r) / r
        want_c = -(1.0 + kappa * r) * want_g * (1.0 / r) ** 2
    np.testing.assert_allclose(g, want_g, rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(c, want_c, rtol=F64_RTOL, atol=0)


_VEC = torch.tensor([1.0, 2.0])


@pytest.mark.parametrize("of_r2,construct", [
    (lambda r2, p: torch.special.bessel_j0(r2), "special_bessel_j0"),
    (lambda r2, p: torch.sqrt(r2) if p[0] > 0 else r2, "control flow"),
    (lambda r2, p: r2 * float(p[0]), "control flow"),
    (lambda r2, p: _VEC[0] * r2, "captured tensor"),
    (lambda r2, p: torch.atan(r2), "aten.atan"),
], ids=["op", "branch", "float", "captured", "atan"])
def test_refusals_name_the_construct(of_r2, construct):
    """What the generator does not take raises NotImplementedError naming
    it and the way out (backend='torch' takes any kernel); a supported
    kernel traced right after still generates."""
    kern = Kernel("refused", of_r2, (1.0,))
    with pytest.raises(NotImplementedError) as err:
        kernel_source(kern)
    assert construct in str(err.value)
    assert "backend='torch'" in str(err.value)
    assert kernel_source(KERNELS["plummer"]).n_params == 1


def test_cache_key_is_the_generated_text():
    """Kernels that differ only in default params share one generated
    text and so one user library; two lambdas with one body too; another
    body gets another library, and a user library is never a base one."""
    a = Kernel("a", _plummer, (1e-2,), ("eps2",))
    b = Kernel("b", _plummer, (5e-1,), ("eps2",))
    f1 = lambda r2, p: 1.0 / (2.0 + r2)   # noqa: E731
    f2 = lambda r2, p: 1.0 / (2.0 + r2)   # noqa: E731
    f3 = lambda r2, p: 1.0 / (3.0 + r2)   # noqa: E731
    texts = {k: kernel_source(Kernel(k, f)).text
             for k, f in (("f1", f1), ("f2", f2), ("f3", f3))}
    assert kernel_source(a).text == kernel_source(b).text
    assert texts["f1"] == texts["f2"] != texts["f3"]
    for name in ("batch_cluster", "batch_cluster_field",
                 "batch_cluster_field_grid"):
        path = {k: _build.library_path(name, t) for k, t in texts.items()}
        assert path["f1"] == path["f2"] != path["f3"]
        assert (_build.library_path(name, kernel_source(a).text)
                == _build.library_path(name, kernel_source(b).text))
        assert path["f1"] != _build.library_path(name)
        assert path["f1"].name.startswith(f"lib{name}_")
        # the grid's degree is part of the key
        deg = [_build.library_path(name, texts["f1"], (f"REPRO_USER_N1={n}",))
               for n in (5, 9)]
        assert deg[0] != deg[1]
    assert (_build.label("batch_cluster", texts["f1"])
            == _build.label("batch_cluster", texts["f2"]) != "batch_cluster")


def test_header_shape():
    """The header declares what the CUDA sources include: the HD macro,
    the parameter count, and both templated functions."""
    src = codegen.generate(_stretched, (2.0,), "stretched")
    assert src.n_params == 1 and len(src.digest) == 16
    for piece in ("#define REPRO_HD __host__ __device__",
                  "#define REPRO_USER_NPAR 1",
                  "REPRO_HD T repro_user_g(T r2, const T* p)",
                  "REPRO_HD void repro_user_gc(T r2, const T* p, T* g, "
                  "T* c)"):
        assert piece in src.text
    none = codegen.generate(_inv_quad, (), "inv_quad")
    assert none.n_params == 0 and "#define REPRO_USER_NPAR 0" in none.text


def test_stripped_kernel_takes_the_call_tree():
    """A plan hands the executor its kernel stripped of defaults and the
    parameter values apart: the header follows the call's tree, and is
    the one the defaults give."""
    kern = KERNELS["plummer"]
    call = (torch.tensor(0.3, dtype=torch.float64),)
    assert (kernel_source(kern.stripped(), call).text
            == kernel_source(kern).text)
    from repro_torch.kernels import batch_cluster as bcm
    kid, src = bcm.kernel_id(kern.stripped(), call)
    assert kid == bcm.USER_ID and src.n_params == 1
    assert bcm.kernel_id(bcm.Kernel("c", _coulomb_user).stripped())[1] \
        .n_params == 0
