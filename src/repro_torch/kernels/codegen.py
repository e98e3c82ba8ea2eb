"""CUDA C++ for a user kernel's G and 2 G', generated from its torch `of_r2`.

The CUDA batch-cluster kernels (`csrc/batch_cluster.cu`,
`csrc/batch_cluster_field.cu`, `csrc/batch_cluster_field_grid.cu`) have
hand-tuned paths for the two built-in kernels. Any other `Kernel` runs
through the same sources built as a *user library*: compiled with
``-DREPRO_USER_KERNEL`` and ``-include`` of a header this module writes,
which defines, in an anonymous namespace,

    template <typename T> T repro_user_g(T r2, const T* p);
    template <typename T> void repro_user_gc(T r2, const T* p, T* g, T* c);

g = G(r2) and c = 2 G'(r2), `p` the kernel's packed parameters
(`potentials.pack_params` order) and ``REPRO_USER_NPAR`` their count.
The user writes G once, as a torch function, as in the reference:

  - G is `of_r2(r2, params)` traced with `make_fx` on 0-d float64
    tensors, each packed parameter a 0-d tensor of its own;
  - 2 G' is `torch.func.jvp` of `of_r2` in r2 (the derivative the plain
    field version takes, `batch_cluster.field_coefficients`), traced the
    same way;
  - each aten op the traces reach maps to CUDA math in T, from a
    whitelist (`_Emitter.call`): arithmetic, sqrt / rsqrt / exp / expm1 / log /
    log1p / pow / tanh / erf / erfc / sin / cos, abs, maximum, minimum,
    clamp, where and its comparisons, scalar constants (rounded to T),
    and the dtype, shape and copy no-ops tracing leaves.

Any other op, a captured tensor of more than one element, or Python
control flow on r2 or a parameter (tracing meets it as
`aten._local_scalar_dense`) raises `NotImplementedError` naming it;
``backend="torch"`` takes any kernel. Nothing falls back in silence.

The text depends only on the traced graphs and the parameter count, so
it is the cache key of a user library (`_build.library_path` hashes it):
two kernels that differ only in default parameters, or two lambdas with
one body, share a build. Functions are ``REPRO_HD``: ``__host__
__device__ __forceinline__`` under nvcc, ``inline`` under a host
compiler, so the CPU tests compile the very text with g++. The kernels
evaluate them on the masked value (r2 where r2 >= FLT_MIN in f32, r2 > 0
in f64, else 1), as `Kernel.__call__` does, never at r2 == 0.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

#: The header's start: the HD macro and the math in T both compilers take.
PRELUDE = r"""#pragma once
#include <math.h>

#if defined(__CUDACC__)
#define REPRO_HD __host__ __device__ __forceinline__
#else
#define REPRO_HD inline
#endif

namespace {

#define REPRO_UNARY(name, f32, f64)                           \
  REPRO_HD float repro_##name(float x) { return f32(x); }     \
  REPRO_HD double repro_##name(double x) { return f64(x); }
REPRO_UNARY(sqrt, sqrtf, sqrt)
REPRO_UNARY(exp, expf, exp)
REPRO_UNARY(expm1, expm1f, expm1)
REPRO_UNARY(log, logf, log)
REPRO_UNARY(log1p, log1pf, log1p)
REPRO_UNARY(tanh, tanhf, tanh)
REPRO_UNARY(erf, erff, erf)
REPRO_UNARY(erfc, erfcf, erfc)
REPRO_UNARY(sin, sinf, sin)
REPRO_UNARY(cos, cosf, cos)
REPRO_UNARY(abs, fabsf, fabs)
#undef REPRO_UNARY

REPRO_HD float repro_pow(float x, float y) { return powf(x, y); }
REPRO_HD double repro_pow(double x, double y) { return pow(x, y); }
// torch's maximum / minimum: a NaN on either side gives NaN
template <typename T>
REPRO_HD T repro_max(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
REPRO_HD T repro_min(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T>
REPRO_HD T repro_sgn(T a) { return T((a > T(0)) - (a < T(0))); }

}  // namespace
"""

#: torch's pow with a scalar exponent takes these as cheaper ops (ATen's
#: pow_tensor_scalar_optimized_kernel); the generated code does the same,
#: and takes +-1.5 (the derivative of a +-1/2 power) without a pow too.
#: A reciprocal square root is the IEEE 1 / sqrt in both precisions, on
#: the card as in the host tests (no approximate intrinsic).
_POW_SPECIAL = {1.0: "{x}", 2.0: "{x} * {x}", 3.0: "{x} * {x} * {x}",
                0.5: "repro_sqrt({x})", -0.5: "T(1) / repro_sqrt({x})",
                -1.0: "T(1) / {x}", -2.0: "T(1) / ({x} * {x})",
                1.5: "{x} * repro_sqrt({x})",
                -1.5: "T(1) / (repro_sqrt({x}) * {x})"}

_UNARY = ("sqrt", "exp", "expm1", "log", "log1p", "tanh", "erf",
          "erfc", "sin", "cos", "abs")
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
#: Ops that pass their first operand through: views, copies and the
#: dtype casts tracing leaves (`_to_copy` is checked on its own).
_IDENTITY = ("alias", "clone", "detach", "expand", "view",
             "lift_fresh_copy")
#: Constant makers: the value is their `fill` (or 0 / 1).
_FILL = {"zeros": 0.0, "zeros_like": 0.0, "_efficientzerotensor": 0.0,
         "ones_like": 1.0}
_FULL = ("full_like", "scalar_tensor")

ANY_KERNEL = "backend='torch' takes any kernel"


@dataclasses.dataclass(frozen=True)
class Generated:
    """A user kernel's generated header: `text`, its `digest` (16 hex of
    sha256, the cache key), and `n_params`, the packed parameters it
    reads (``REPRO_USER_NPAR``)."""

    text: str
    digest: str
    n_params: int


class _Refused(Exception):
    """A construct the generator does not take (its description)."""


def _leaf_count(tree) -> int:
    if isinstance(tree, (tuple, list)):
        return sum(_leaf_count(t) for t in tree)
    return 1


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in order, by `leaves` (an
    iterator)."""
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def _literal(v) -> str:
    """A Python scalar as a T expression (rounded to T by the cast)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    v = float(v)
    if math.isnan(v):
        return "T(NAN)"
    if math.isinf(v):
        return "T(INFINITY)" if v > 0 else "T(-INFINITY)"
    return f"T({v!r})"


class _Emitter:
    """C++ statements for the nodes of one traced graph that its output
    reaches, each a `const` local of type T or bool."""

    def __init__(self, gm, dtype):
        self.gm = gm
        self.dtype = dtype
        self.expr = {}        # node -> (C++ expression, "T" | "bool")
        self.lines = []
        self.params = 0

    def operand(self, a, want="T"):
        """The C++ expression of an op's argument, as T (bool converted)
        or as bool."""
        if isinstance(a, torch.fx.Node):
            e, kind = self.expr[a]
        elif isinstance(a, (bool, int, float)):
            e, kind = _literal(a), "bool" if isinstance(a, bool) else "T"
        else:
            raise _Refused(f"an operand {a!r} of type {type(a).__name__}")
        if want == kind:
            return e
        return f"T({e})" if want == "T" else f"({e} != T(0))"

    def bind(self, node, e, kind="T"):
        name = f"v{len(self.lines)}"
        ctype = "T" if kind == "T" else "bool"
        self.lines.append(f"  const {ctype} {name} = {e};")
        self.expr[node] = (name, kind)

    def constant(self, node, v, kind="T"):
        self.expr[node] = (_literal(v) if kind == "T"
                           else ("true" if v else "false"), kind)

    def emit(self, out_nodes):
        # r2, then the parameters in packed order, whether used or not
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.expr[node] = ("r2" if self.params == 0
                                   else f"p[{self.params - 1}]", "T")
                self.params += 1
        need = set()
        todo = list(out_nodes)
        while todo:
            n = todo.pop()
            if n in need:
                continue
            need.add(n)
            todo.extend(n.all_input_nodes)
        for node in self.gm.graph.nodes:
            if node in need and node.op not in ("output", "placeholder"):
                self.node(node)

    def node(self, node):
        if node.op == "get_attr":
            t = getattr(self.gm, node.target)
            if not isinstance(t, torch.Tensor) or t.numel() != 1:
                raise _Refused(f"a captured tensor of shape "
                               f"{tuple(getattr(t, 'shape', ()))} (only "
                               f"one-element tensors are constants)")
            if t.is_complex():
                raise _Refused(f"a captured {t.dtype} tensor")
            # a constant the trace captured: a CPU tensor, read once a
            # kernel function (kernel_source caches the header)
            v = t.item()  # lint: disable=HS001 — a CPU constant, no sync
            self.constant(node, bool(v) if t.dtype == torch.bool
                          else float(v),
                          "bool" if t.dtype == torch.bool else "T")
            return
        if node.op != "call_function":
            raise _Refused(f"a graph node of kind {node.op!r}")
        self.call(node, str(node.target))

    def call(self, node, target):
        ns, op, overload = (target.split(".") + ["", ""])[:3]
        a, kw = node.args, node.kwargs
        x = self.operand
        if ns not in ("aten", "prims"):
            raise _Refused(f"op {target}")
        if op in ("add", "sub", "rsub", "mul", "div"):
            if kw.get("rounding_mode") is not None:
                raise _Refused(f"op {target} with rounding_mode")
            lhs, rhs = x(a[0]), x(a[1])
            alpha = kw.get("alpha", a[2] if len(a) > 2 else None)
            if op == "rsub":                  # rhs - alpha * lhs
                lhs, rhs, op = rhs, lhs, "sub"
            if alpha is not None and op in ("add", "sub"):
                rhs = f"{_literal(alpha)} * {rhs}"
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            self.bind(node, f"{lhs} {sym} ({rhs})")
        elif op == "rsqrt":
            self.bind(node, f"T(1) / repro_sqrt({x(a[0])})")
        elif op == "neg":
            self.bind(node, f"-{x(a[0])}")
        elif op == "reciprocal":
            self.bind(node, f"T(1) / {x(a[0])}")
        elif op in _UNARY:
            self.bind(node, f"repro_{op}({x(a[0])})")
        elif op == "sgn":                    # the derivative of abs
            self.bind(node, f"repro_sgn({x(a[0])})")
        elif op == "tanh_backward":          # grad * (1 - y^2)
            self.bind(node, f"{x(a[0])} * (T(1) - {x(a[1])} * {x(a[1])})")
        elif op == "pow":
            if overload == "Tensor_Scalar" and float(a[1]) in _POW_SPECIAL:
                e = _POW_SPECIAL[float(a[1])].format(x=x(a[0]))
            else:
                e = f"repro_pow({x(a[0])}, {x(a[1])})"
            self.bind(node, e)
        elif op in ("maximum", "minimum"):
            fn = "repro_max" if op == "maximum" else "repro_min"
            self.bind(node, f"{fn}({x(a[0])}, {x(a[1])})")
        elif op in ("clamp", "clamp_min", "clamp_max"):
            lo = kw.get("min", a[1] if len(a) > 1 else None)
            hi = kw.get("max", a[2] if len(a) > 2 else None)
            if op == "clamp_max":
                lo, hi = None, a[1]
            e = x(a[0])
            if lo is not None:
                e = f"repro_max({e}, {x(lo)})"
            if hi is not None:
                e = f"repro_min({e}, {x(hi)})"
            self.bind(node, e)
        elif op in _COMPARE:
            self.bind(node, f"{x(a[0])} {_COMPARE[op]} {x(a[1])}", "bool")
        elif op == "logical_and":            # the derivative of pow
            self.bind(node, f"{x(a[0], 'bool')} && {x(a[1], 'bool')}",
                      "bool")
        elif op == "where":
            self.bind(node, f"{x(a[0], 'bool')} ? {x(a[1])} : {x(a[2])}")
        elif op in _FILL or op in _FULL:
            v = _FILL.get(op)
            if v is None:
                v = a[0] if op == "scalar_tensor" else a[1]
            if kw.get("dtype") == torch.bool:
                self.constant(node, bool(v), "bool")
            else:                             # rounded to T as it is used
                self.constant(node, v)
        elif op == "copy":
            self.expr[node] = self.expr_of(a[1])
        elif op == "_to_copy":
            dtype = kw.get("dtype")
            src = self.expr_of(a[0])
            if dtype is None:
                self.expr[node] = src
            elif dtype == torch.bool:
                self.expr[node] = (x(a[0], "bool"), "bool")
            else:
                self.check_dtype(dtype, target)
                self.expr[node] = (x(a[0]), "T")
        elif op in _IDENTITY:
            self.expr[node] = self.expr_of(a[0])
        else:
            raise _Refused(f"op {target}")

    def expr_of(self, a):
        if isinstance(a, torch.fx.Node):
            return self.expr[a]
        return (_literal(a), "bool" if isinstance(a, bool) else "T")

    def check_dtype(self, dtype, target):
        """A cast or constant in the traced dtype (or none) is a no-op; a
        cast to another type would round where T does not."""
        if dtype is not None and dtype != self.dtype:
            raise _Refused(f"op {target} to {dtype}")


def _trace(fn, args):
    from torch.fx.experimental.proxy_tensor import make_fx
    try:
        return make_fx(fn)(*args)
    except RuntimeError as e:
        if "_local_scalar_dense" not in str(e):
            raise
        raise _Refused("Python control flow on r2 or a parameter, or a "
                       "Python number taken from one (tracing met "
                       "aten._local_scalar_dense)") from e


def _function(gm, dtype, outputs, signature, ret):
    """One templated C++ function from a traced graph."""
    out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(outs) != outputs:
        raise _Refused(f"{len(outs)} outputs from of_r2's trace")
    em = _Emitter(gm, dtype)
    em.emit([o for o in outs if isinstance(o, torch.fx.Node)])
    values = []
    for o in outs:
        e, kind = em.expr_of(o)
        if kind != "T":
            raise _Refused("a boolean result")
        values.append(e)
    body = "\n".join(em.lines + ret(values))
    return (f"template <typename T>\nREPRO_HD {signature} {{\n"
            f"{body}\n}}\n")


def generate(of_r2, params=(), name: str = "kernel") -> Generated:
    """The generated header of the kernel `of_r2` called with parameter
    trees shaped as `params` (nested tuples; its leaves, whatever they
    hold, set the packed order, and their values are not used). Raises
    NotImplementedError naming what it does not take."""
    n = _leaf_count(params) if params != () else 0
    dtype = torch.float64
    r2 = torch.tensor(0.7, dtype=dtype)
    pvals = tuple(torch.tensor(0.3 + 0.1 * k, dtype=dtype)
                  for k in range(n))

    def tree(ps):
        return _rebuild(params, iter(ps)) if n else params

    def g(r2, *ps):
        return of_r2(r2, tree(ps))

    def gc(r2, *ps):
        t = tree(ps)
        v, d = torch.func.jvp(lambda s: of_r2(s, t), (r2,),
                              (torch.ones_like(r2),))
        return v, 2.0 * d

    try:
        for fn in (g, gc):
            val = fn(r2, *pvals)
            vals = val if isinstance(val, tuple) else (val,)
            for v in vals:
                if not isinstance(v, torch.Tensor) or v.dim() != 0:
                    raise _Refused(
                        f"a result of shape {tuple(getattr(v, 'shape', ()))}"
                        f" or type {type(v).__name__} for a 0-d r2 (G must "
                        f"be elementwise)")
        text_g = _function(_trace(g, (r2, *pvals)), dtype, 1,
                           "T repro_user_g(T r2, const T* p)",
                           lambda v: [f"  return {v[0]};"])
        text_gc = _function(_trace(gc, (r2, *pvals)), dtype, 2,
                            "void repro_user_gc(T r2, const T* p, T* g, "
                            "T* c)",
                            lambda v: [f"  *g = {v[0]};", f"  *c = {v[1]};"])
    except _Refused as e:
        raise NotImplementedError(
            f"kernel {name!r}: the CUDA code generator does not take "
            f"{e}; {ANY_KERNEL}") from e
    text = (PRELUDE + f"\n#define REPRO_USER_NPAR {n}\n\nnamespace {{\n\n"
            "// G(r2) and 2 G'(r2), generated from the kernel's torch "
            "of_r2\n" + text_g + "\n" + text_gc + "\n}  // namespace\n")
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    return Generated(text, digest, n)
