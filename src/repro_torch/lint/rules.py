"""Rule registry: each rule is a small class with an id, a severity and
a `check` over one module (given the resolver's hot-function set).

Port of `repro/lint/rules.py`, each rule the twin of a reference rule
in PyTorch's terms. On CUDA a host sync is not a trace error but a
stall: the host waits for the card's queue to drain. So the hot-function
rules flag what makes eager PyTorch wait:

- HS001 (twin of TS002 and TS001): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``np.asarray(t)`` /
  ``np.array(t)`` in a hot function;
- HS002 (twin of TS003 and TS004): ``float/int/bool(t)``, ``if t:`` /
  ``while t:`` on a tensor-valued expression and ``assert`` on one:
  implicit ``_local_scalar_dense`` calls;
- HS003 (no twin: jit forbids it): data-dependent shapes in a hot
  function (``nonzero``, ``masked_select``, ``unique``, one-argument
  ``torch.where``, boolean-mask indexing), each a hidden sync;
- TS006 (``print``, a warning) and ND001 (Python ``random``, global
  ``np.random``, ``time.*`` outside `repro_torch.obs`) in hot code;
- OB001: ``torch.cuda.synchronize()``, ``Event.synchronize()`` or
  ``Stream.synchronize()`` outside an ``obs.trace.enabled()`` gate (the
  reference's ``block_until_ready`` rule);
- DV001 / DV002: the port's devtree contract (`devtree/__init__.py`):
  no float-accumulating scatter (integer and min/max ``scatter_reduce_``
  are allowed), no data-dependent shape, every sort ``stable=True``.

Code inside ``with explicit_sync(reason):`` (`repro_torch.lint.runtime`)
is a sanctioned pull, the reference's explicit ``jax.device_get``: the
sync rules stay quiet there, and the runtime counts it.

No twin: TS005 (unhashable static arguments: nothing is jitted, so
there are no static arguments) and DN001 (donated buffers: the port
donates nothing; ``donate_charges`` was not carried over).

"Tensor-valued" is the reference's parameter taint: the parameters of a
hot function are tensors unless annotated otherwise or given a non-None
default, assignments carry taint forward, and host reads
(``.shape``, ``.dtype``, ``.device``, ``.dim()``, ``len()``, a call to a
function annotated ``-> str/int/float/bool``, ...) clear it.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.lint.findings import Finding, Severity
from repro_torch.lint.resolver import (FunctionInfo, HotResolver, ModuleInfo,
                                       SCALAR_ANNOTATIONS, dotted_name)

UNTAINT_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
                 "layout", "requires_grad", "is_sparse"}
UNTAINT_METHODS = {"dim", "size", "numel", "nelement", "is_contiguous",
                   "stride", "element_size", "get_device",
                   "is_floating_point", "is_complex", "storage_offset"}
HOST_BUILTINS = {"len", "isinstance", "type", "hasattr", "callable", "id",
                 "float", "int", "bool", "complex", "str", "repr"}
PULL_METHODS = {"item", "tolist", "cpu", "numpy"}
SHAPE_CALLS = {"nonzero", "masked_select", "unique", "unique_consecutive",
               "argwhere"}
BOOL_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
              "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
              "ge", "bool"}
NONDET_MODULES = {"random", "time", "datetime", "uuid", "secrets"}
SEEDED_NP_RANDOM = {"default_rng", "Generator", "SeedSequence", "PCG64"}
ACCUMULATING_SCATTERS = {"scatter_add", "scatter_add_", "index_add",
                         "index_add_"}
SORT_CALLS = {"sort", "argsort"}


def _is_explicit_sync(item: ast.withitem) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Call) and (
        dotted_name(e.func) or "").rsplit(".", 1)[-1] == "explicit_sync"


def _mentions_enabled(test) -> bool:
    for n in ast.walk(test):
        d = dotted_name(n.func if isinstance(n, ast.Call) else n) \
            if isinstance(n, (ast.Call, ast.Name, ast.Attribute)) else None
        if d and d.rsplit(".", 1)[-1] in ("enabled", "_enabled"):
            return True
    return False


def _early_exit_unless_enabled(stmt) -> bool:
    """``if not enabled(): return`` (the rest of the block is gated)."""
    return (isinstance(stmt, ast.If) and not stmt.orelse
            and isinstance(stmt.test, ast.UnaryOp)
            and isinstance(stmt.test.op, ast.Not)
            and _mentions_enabled(stmt.test.operand)
            and isinstance(stmt.body[-1], ast.Return))


def gated_nodes(root: ast.AST, nested: bool = False
                ) -> Iterator[Tuple[ast.AST, bool, bool]]:
    """(node, in_sync, in_trace) for the nodes under `root`: in_sync
    inside ``with explicit_sync(...)``, in_trace under an
    ``enabled()`` gate. Nested function defs are skipped unless
    `nested` (a nested def of a hot function is hot on its own)."""

    def walk(node, in_sync, in_trace):
        gate = False
        for c in ast.iter_child_nodes(node):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)) and not nested:
                continue
            t = in_trace or gate
            if isinstance(c, ast.If) and _mentions_enabled(c.test) \
                    and not _early_exit_unless_enabled(c):
                yield c, in_sync, t
                for b in c.body:
                    yield from walk_self(b, in_sync, True)
                for b in c.orelse:
                    yield from walk_self(b, in_sync, t)
                continue
            if isinstance(c, ast.With) and any(
                    _is_explicit_sync(i) for i in c.items):
                yield c, in_sync, t
                for i in c.items:
                    yield from walk_self(i, in_sync, t)
                for b in c.body:
                    yield from walk_self(b, True, t)
                continue
            yield from walk_self(c, in_sync, t)
            if _early_exit_unless_enabled(c):
                gate = True

    def walk_self(node, in_sync, in_trace):
        yield node, in_sync, in_trace
        yield from walk(node, in_sync, in_trace)

    yield from walk(root, False, False)


def hot_nodes(fn: FunctionInfo) -> Iterator[ast.AST]:
    """The nodes of a hot function's own body outside explicit_sync."""
    for node, in_sync, _ in gated_nodes(fn.node):
        if not in_sync:
            yield node


def _target_names(t) -> Iterator[str]:
    """Names bound (or mutated through) by an assignment target."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _target_names(e)
    elif isinstance(t, ast.Starred):
        yield from _target_names(t.value)
    elif isinstance(t, (ast.Subscript, ast.Attribute)):
        yield from _target_names(t.value)


CONTAINER_NODES = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp,
                   ast.SetComp, ast.DictComp)


def _scalar_annotation(ann) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id in SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Constant):
        return ann.value in SCALAR_ANNOTATIONS
    return False


def _container_names(fn_node) -> Set[str]:
    """Names every binding of which (in this body) is a list, tuple,
    dict or set display: testing their truth reads a length, not a
    tensor."""
    bound: Dict[str, bool] = {}
    for node, _s, _t in gated_nodes(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    ok = isinstance(node.value, CONTAINER_NODES)
                    bound[t.id] = bound.get(t.id, True) and ok
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name):
            ok = isinstance(node.value, CONTAINER_NODES)
            bound[node.target.id] = bound.get(node.target.id, True) and ok
    return {k for k, v in bound.items() if v}


def _host_param(a: ast.arg, default) -> bool:
    """A parameter that is not a tensor by contract: annotated with a
    type that names no Tensor, or defaulting to anything but None."""
    ann = a.annotation
    if ann is not None and "Tensor" not in ast.unparse(ann):
        return True
    return default is not None and not (
        isinstance(default, ast.Constant) and default.value is None)


def _host_params(fn: FunctionInfo) -> Set[str]:
    args = fn.node.args
    pos = list(args.posonlyargs) + list(args.args)
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    out = {a.arg for a, d in zip(pos, defaults) if _host_param(a, d)}
    out |= {a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
            if _host_param(a, d)}
    return out


class TaintEngine:
    """Inter-procedural parameter taint, memoized across modules (the
    reference's engine): a parameter of a function reached from hot code
    is tensor-valued only when a resolved call site binds a
    tensor-valued expression to it; roots and call-site-less functions
    stay conservative."""

    def __init__(self, resolver: HotResolver):
        self.resolver = resolver
        self._memo: Dict[int, Set[str]] = {}
        self._ret_memo: Dict[tuple, bool] = {}
        self._local_memo: Dict[int, Set[str]] = {}
        self._in_progress: Set[int] = set()

    # -- expressions ---------------------------------------------------

    def host_call(self, fn: FunctionInfo, call: ast.Call) -> bool:
        """True for a call whose result is a host value whatever its
        arguments."""
        f = call.func
        if isinstance(f, ast.Name) and f.id in HOST_BUILTINS:
            return True
        if isinstance(f, ast.Attribute) and f.attr in (UNTAINT_METHODS
                                                       | PULL_METHODS):
            return True     # a host value (a pull is HS001 on its own)
        mod = self.resolver.by_path.get(fn.path)
        if mod is None:
            return False
        d = dotted_name(f) or ""
        if d.split(".")[0] in mod.numpy_aliases():
            return True     # numpy returns host arrays
        callees = self.resolver.resolve_call(mod, fn, call)
        return bool(callees) and all(self.returns_host(c)
                                     for c in callees)

    def returns_host(self, fn: FunctionInfo) -> bool:
        """True when fn is annotated to return a Python scalar, or every
        value it returns is a host value under its conservative taint."""
        if _scalar_annotation(getattr(fn.node, "returns", None)):
            return True
        key = ("ret", id(fn))
        if key in self._ret_memo:
            return self._ret_memo[key]
        self._ret_memo[key] = False          # recursion: not host
        taint = self._conservative_params(fn) | self._captures(fn)
        taint = self._forward(fn, taint)
        rets = [n.value for n in ast.walk(fn.node)
                if isinstance(n, ast.Return) and n.value is not None
                and self._owner(fn, n)]
        out = bool(rets) and not any(self.tainted(r, taint, fn)
                                     for r in rets)
        self._ret_memo[key] = out
        return out

    def returns_container(self, fn: FunctionInfo) -> bool:
        """True when every value fn returns is a list/tuple/dict/set
        display (or a name only ever bound to one)."""
        names = _container_names(fn.node)
        rets = [n.value for n in ast.walk(fn.node)
                if isinstance(n, ast.Return) and n.value is not None
                and self._owner(fn, n)]
        return bool(rets) and all(
            isinstance(r, CONTAINER_NODES)
            or (isinstance(r, ast.Name) and r.id in names) for r in rets)

    @staticmethod
    def _owner(fn: FunctionInfo, node) -> bool:
        """`node` lies in fn's own body, not in a nested def."""
        for n in ast.walk(fn.node):
            if n is not fn.node and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                if any(c is node for c in ast.walk(n)):
                    return False
        return True

    def _captures(self, fn: FunctionInfo) -> Set[str]:
        if fn.parent is not None and fn.parent.traced:
            return self.local_taint(fn.parent) - set(fn.params)
        return set()

    def tainted(self, node, taint: Set[str], fn: FunctionInfo) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in taint
        if isinstance(node, ast.Attribute):
            if node.attr in UNTAINT_ATTRS:
                return False
            return self.tainted(node.value, taint, fn)
        if isinstance(node, ast.Call):
            if self.host_call(fn, node):
                return False
            if any(self.tainted(a, taint, fn) for a in node.args):
                return True
            if any(self.tainted(k.value, taint, fn) for k in node.keywords):
                return True
            if isinstance(node.func, ast.Attribute):
                return self.tainted(node.func.value, taint, fn)
            return False
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            inner = set(taint)
            for gen in node.generators:
                if self.tainted(gen.iter, inner, fn):
                    inner.update(_target_names(gen.target))
            elts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            return any(self.tainted(e, inner, fn) for e in elts)
        return any(self.tainted(c, taint, fn)
                   for c in ast.iter_child_nodes(node))

    # -- parameters and locals -------------------------------------------

    def _conservative_params(self, fn: FunctionInfo) -> Set[str]:
        return set(fn.params) - {"self", "cls", "ctx"} - _host_params(fn)

    def _bound_args(self, fn: FunctionInfo, call: ast.Call):
        params = list(fn.params[:fn.n_positional])
        if params and params[0] in ("self", "cls") \
                and fn.class_name is not None:
            params = params[1:]
        bindings: Dict[str, List[ast.AST]] = {}
        precise = True
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                precise = False
                continue
            if i < len(params):
                bindings.setdefault(params[i], []).append(a)
        for kw in call.keywords:
            if kw.arg is None:
                precise = False
            elif kw.arg in fn.params:
                bindings.setdefault(kw.arg, []).append(kw.value)
        return bindings, precise

    def param_set(self, fn: FunctionInfo) -> Set[str]:
        if id(fn) in self._memo:
            return self._memo[id(fn)]
        conservative = self._conservative_params(fn)
        if id(fn) in self._in_progress:
            return conservative
        if fn.is_root or not fn.call_sites:
            self._memo[id(fn)] = conservative
            return conservative
        self._in_progress.add(id(fn))
        try:
            tainted: Set[str] = set()
            for caller, call in fn.call_sites:
                caller_taint = self.local_taint(caller)
                bindings, precise = self._bound_args(fn, call)
                if not precise:
                    tainted |= conservative
                    continue
                for p, exprs in bindings.items():
                    if any(self.tainted(e, caller_taint, caller)
                           for e in exprs):
                        tainted.add(p)
            out = tainted & conservative
        finally:
            self._in_progress.discard(id(fn))
        self._memo[id(fn)] = out
        return out

    def local_taint(self, fn: FunctionInfo) -> Set[str]:
        """Tensor-valued names in fn's body: params, closure captures
        from a hot enclosing function, forward assignments."""
        if id(fn) in self._local_memo:
            return self._local_memo[id(fn)]
        tainted = set(self.param_set(fn))
        if fn.parent is not None and fn.parent.traced \
                and id(fn.parent) not in self._in_progress:
            self._in_progress.add(id(fn))
            try:
                tainted |= self.local_taint(fn.parent) - set(fn.params)
            finally:
                self._in_progress.discard(id(fn))
        tainted = self._forward(fn, tainted)
        self._local_memo[id(fn)] = tainted
        return tainted

    def _loop_targets(self, node: ast.For, tainted, fn) -> Iterator[str]:
        """Names a for loop binds to tensor values: a dict's keys are
        host values (``for k, v in d.items()``), and a literal of tuples
        taints position by position."""
        it, tgt = node.iter, node.target
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute):
            if it.func.attr == "keys":
                return
            if it.func.attr == "items" and isinstance(tgt, ast.Tuple) \
                    and len(tgt.elts) == 2:
                if self.tainted(it.func.value, tainted, fn):
                    yield from _target_names(tgt.elts[1])
                return
        if isinstance(it, (ast.Tuple, ast.List)) \
                and isinstance(tgt, ast.Tuple) and it.elts and all(
                    isinstance(e, ast.Tuple)
                    and len(e.elts) == len(tgt.elts) for e in it.elts):
            for i, t in enumerate(tgt.elts):
                if any(self.tainted(e.elts[i], tainted, fn)
                       for e in it.elts):
                    yield from _target_names(t)
            return
        if self.tainted(it, tainted, fn):
            yield from _target_names(tgt)

    def _forward(self, fn: FunctionInfo, tainted: Set[str]) -> Set[str]:
        tainted = set(tainted)
        for _ in range(2):  # two passes approximate a fixpoint
            for node, _s, _t in gated_nodes(fn.node):
                if isinstance(node, ast.Assign) \
                        and self.tainted(node.value, tainted, fn):
                    for t in node.targets:
                        tainted.update(_target_names(t))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                        and self.tainted(node.value, tainted, fn) \
                        and isinstance(node.target, ast.Name):
                    tainted.add(node.target.id)
                elif isinstance(node, ast.For):
                    tainted.update(self._loop_targets(node, tainted, fn))
                elif isinstance(node, ast.withitem) \
                        and node.optional_vars is not None \
                        and self.tainted(node.context_expr, tainted, fn):
                    tainted.update(_target_names(node.optional_vars))
        return tainted


class RuleContext:
    """Everything a rule can look at for one module."""

    def __init__(self, module: ModuleInfo, resolver: HotResolver,
                 engine: Optional[TaintEngine] = None):
        self.module = module
        self.resolver = resolver
        self.hot = [f for f in module.functions if f.traced]
        self.engine = engine or TaintEngine(resolver)

    def taint(self, fn: FunctionInfo) -> Set[str]:
        return self.engine.local_taint(fn)

    def tainted(self, node, fn: FunctionInfo) -> bool:
        return self.engine.tainted(node, self.taint(fn), fn)


class Rule:
    id: str = ""
    severity: str = Severity.ERROR
    description: str = ""

    def check(self, ctx: RuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: RuleContext, node, message: str,
                fn: Optional[FunctionInfo] = None) -> Finding:
        return Finding(
            rule=self.id, severity=self.severity, path=ctx.module.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1, message=message,
            context=(f"hot via {fn.trace_via}" if fn is not None
                     else None))


# ---------------------------------------------------------------------
# hot-function host-sync rules
# ---------------------------------------------------------------------

def _is_cpu_target(node) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and (dotted_name(node.func) or "") \
            .endswith("device"):
        return bool(node.args) and _is_cpu_target(node.args[0])
    return False


class HostPull(Rule):
    id = "HS001"
    description = (".item()/.tolist()/.cpu()/.numpy()/.to('cpu')/"
                   "np.asarray(tensor) in a hot function: a device-to-"
                   "host copy the host waits for")

    def check(self, ctx):
        np_aliases = ctx.module.numpy_aliases()
        for fn in ctx.hot:
            for node in hot_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                what = None
                if isinstance(f, ast.Attribute) and f.attr in PULL_METHODS:
                    what = f".{f.attr}()"
                elif isinstance(f, ast.Attribute) and f.attr == "to" and (
                        any(_is_cpu_target(a) for a in node.args[:1])
                        or any(k.arg == "device" and _is_cpu_target(k.value)
                               for k in node.keywords)):
                    what = ".to('cpu')"
                else:
                    d = dotted_name(f) or ""
                    head, _, last = d.rpartition(".")
                    if head in np_aliases and last in ("asarray", "array") \
                            and any(ctx.tainted(a, fn) for a in node.args):
                        what = f"{d}(tensor)"
                if what:
                    yield self.finding(
                        ctx, node,
                        f"`{what}` in hot function `{fn.name}` pulls to "
                        f"the host (wrap a sanctioned pull in "
                        f"`explicit_sync(reason)`)", fn)


class ImplicitScalar(Rule):
    id = "HS002"
    description = ("float()/int()/bool() of a tensor, or `if`/`while`/"
                   "`assert` on one, in a hot function: an implicit "
                   "_local_scalar_dense (a host sync)")

    _CASTS = {"float", "int", "bool", "complex"}

    def _tainted_test(self, ctx, fn, test) -> bool:
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in test.ops):
                return False
            return ctx.tainted(test, fn)
        if isinstance(test, ast.BoolOp):
            return any(self._tainted_test(ctx, fn, v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._tainted_test(ctx, fn, test.operand)
        if isinstance(test, ast.Name) and self._container(ctx, fn,
                                                           test.id):
            return False
        return ctx.tainted(test, fn)

    @staticmethod
    def _container(ctx, fn, name: str) -> bool:
        """`name` holds a list/tuple/dict: bound only to displays, or
        to the result of a function that returns only displays."""
        if name in _container_names(fn.node):
            return True
        calls = [n.value for n, _s, _t in gated_nodes(fn.node)
                 if isinstance(n, ast.Assign) and any(
                     isinstance(t, ast.Name) and t.id == name
                     for t in n.targets)]
        if not calls or not all(isinstance(c, ast.Call) for c in calls):
            return False
        mod = ctx.module
        for c in calls:
            callees = ctx.resolver.resolve_call(mod, fn, c)
            if not callees or not all(ctx.engine.returns_container(k)
                                      for k in callees):
                return False
        return True

    def check(self, ctx):
        for fn in ctx.hot:
            for node in hot_nodes(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in self._CASTS and node.args \
                        and ctx.tainted(node.args[0], fn):
                    yield self.finding(
                        ctx, node,
                        f"`{node.func.id}(...)` of a tensor in hot "
                        f"function `{fn.name}` waits for the device", fn)
                elif isinstance(node, (ast.If, ast.While, ast.IfExp,
                                       ast.Assert)) \
                        and self._tainted_test(ctx, fn, node.test):
                    kind = type(node).__name__.lower().replace("ifexp",
                                                               "if")
                    yield self.finding(
                        ctx, node,
                        f"`{kind}` on a tensor in hot function "
                        f"`{fn.name}` waits for the device (use "
                        f"torch.where)", fn)


def _boolish(node, bool_names: Set[str]) -> bool:
    """A mask expression: a comparison, a logical op over one, a
    boolean predicate call, or a name bound to one."""
    if isinstance(node, ast.Compare):
        return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                       ast.NotIn)) for op in node.ops)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _boolish(node.left, bool_names) or _boolish(node.right,
                                                           bool_names)
    if isinstance(node, ast.Call):
        d = dotted_name(node.func) or ""
        return d.rsplit(".", 1)[-1] in BOOL_CALLS
    if isinstance(node, ast.Name):
        return node.id in bool_names
    return False


def _bool_names(fn_node) -> Set[str]:
    names: Set[str] = set()
    for _ in range(2):
        for node, _s, _t in gated_nodes(fn_node):
            if isinstance(node, ast.Assign) and _boolish(node.value, names):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def data_dependent_shapes(ctx, fn, nodes) -> Iterator[Tuple[ast.AST, str]]:
    """(node, what) for each op in `nodes` whose output shape depends on
    the data (a hidden device-to-host read of the size on CUDA)."""
    masks = _bool_names(fn.node)
    for node in nodes:
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            last = d.rsplit(".", 1)[-1]
            if isinstance(node.func, ast.Attribute) and last in SHAPE_CALLS:
                yield node, f"`{last}`"
            elif last == "where" and len(node.args) == 1 \
                    and not node.keywords:
                yield node, "one-argument `torch.where`"
        elif isinstance(node, ast.Subscript):
            parts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                     else [node.slice])
            if isinstance(node.ctx, ast.Load) \
                    and any(_boolish(p, masks) for p in parts) \
                    and ctx.tainted(node.value, fn):
                yield node, "boolean-mask indexing"
        elif isinstance(node, ast.Assign) and not isinstance(
                node.value, ast.Constant):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and any(
                        _boolish(p, masks) for p in (
                            t.slice.elts if isinstance(t.slice, ast.Tuple)
                            else [t.slice])):
                    yield t, "boolean-mask assignment of a tensor"


class DataDependentShape(Rule):
    id = "HS003"
    description = ("nonzero/masked_select/unique/one-argument where/"
                   "boolean-mask indexing in a hot function: the output "
                   "size is read back from the device")

    def check(self, ctx):
        for fn in ctx.hot:
            for node, what in data_dependent_shapes(ctx, fn, hot_nodes(fn)):
                yield self.finding(
                    ctx, node,
                    f"{what} in hot function `{fn.name}` has a data-"
                    f"dependent shape (a hidden sync on CUDA)", fn)


class PrintInHot(Rule):
    id = "TS006"
    severity = Severity.WARNING
    description = ("print() in a hot function: host I/O in the steady "
                   "loop (log through repro_torch.obs)")

    def check(self, ctx):
        for fn in ctx.hot:
            for node in hot_nodes(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "print":
                    yield self.finding(
                        ctx, node,
                        f"print() in hot function `{fn.name}`", fn)


def _in_package(path: str, name: str) -> bool:
    return name in path.replace("\\", "/").split("/")


class NondeterminismInHot(Rule):
    id = "ND001"
    description = ("Python random / global np.random / time.* in a hot "
                   "function outside repro_torch.obs: a host value that "
                   "changes between runs")

    def check(self, ctx):
        mod = ctx.module
        if _in_package(mod.path, "obs"):
            return
        np_aliases = mod.numpy_aliases()
        nondet_aliases = {a for a, m in mod.imports.items()
                          if m.split(".")[0] in NONDET_MODULES}
        nondet_names = {a for a, (src, _) in mod.from_imports.items()
                        if src.split(".")[0] in NONDET_MODULES}
        for fn in ctx.hot:
            for node, _s, _t in gated_nodes(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted_name(node.func)
                if d is None:
                    continue
                parts = d.split(".")
                bad = parts[0] in nondet_aliases or (
                    len(parts) == 1 and d in nondet_names)
                if parts[0] in np_aliases and parts[1:2] == ["random"]:
                    bad = not (parts[-1] in SEEDED_NP_RANDOM and node.args)
                if bad:
                    yield self.finding(
                        ctx, node,
                        f"`{d}(...)` in hot function `{fn.name}` is host "
                        f"nondeterminism (seed a torch.Generator, or time "
                        f"through repro_torch.obs)", fn)


# ---------------------------------------------------------------------
# package-contract rules
# ---------------------------------------------------------------------

class SyncOutsideObsGate(Rule):
    id = "OB001"
    description = ("torch.cuda.synchronize / Event.synchronize / "
                   "Stream.synchronize outside an obs `enabled()` gate: "
                   "untraced runs keep the launches asynchronous")

    def check(self, ctx):
        for node, in_sync, in_trace in gated_nodes(ctx.module.tree,
                                                   nested=True):
            if in_sync or in_trace or not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "synchronize":
                yield self.finding(
                    ctx, node,
                    f"`{dotted_name(node.func) or '.synchronize'}()` "
                    f"outside a trace-enabled gate waits for the device "
                    f"(gate on obs.trace.enabled(), wrap it in "
                    f"explicit_sync(reason), or suppress with the reason "
                    f"the wait is the product)")


def _in_devtree(path: str) -> bool:
    return _in_package(path, "devtree")


class ScatterInDevtree(Rule):
    id = "DV001"
    description = ("float-accumulating scatter in repro_torch.devtree "
                   "(scatter_add, index_add, index_put accumulate, "
                   "sum/mean/prod scatter_reduce): the device build is "
                   "deterministic by contract")

    def check(self, ctx):
        if not _in_devtree(ctx.module.path):
            return
        for node in ast.walk(ctx.module.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            name = node.func.attr
            bad = name in ACCUMULATING_SCATTERS
            if name in ("index_put", "index_put_"):
                bad = any(k.arg == "accumulate" and not (
                    isinstance(k.value, ast.Constant)
                    and not k.value.value) for k in node.keywords) or (
                    len(node.args) > 2 and not (
                        isinstance(node.args[2], ast.Constant)
                        and not node.args[2].value))
            if name in ("scatter_reduce", "scatter_reduce_"):
                red = node.args[3] if len(node.args) > 3 else next(
                    (k.value for k in node.keywords if k.arg == "reduce"),
                    None)
                bad = not (isinstance(red, ast.Constant)
                           and red.value in ("amin", "amax"))
            if bad:
                yield self.finding(
                    ctx, node,
                    f"`.{name}(...)` in devtree: a float-accumulating "
                    f"scatter breaks the deterministic-build contract "
                    f"(integer and min/max reductions are allowed: "
                    f"suppress with the reason)")


class ShapeOrSortInDevtree(Rule):
    id = "DV002"
    description = ("data-dependent shape, or a sort without "
                   "stable=True, in repro_torch.devtree: the device build "
                   "keeps fixed shapes and stable orders by contract")

    def check(self, ctx):
        if not _in_devtree(ctx.module.path):
            return
        for fn in ctx.module.functions:
            nodes = [n for n, _s, _t in gated_nodes(fn.node)]
            for node, what in data_dependent_shapes(ctx, fn, nodes):
                yield self.finding(
                    ctx, node, f"{what} in devtree: a data-dependent "
                    f"shape breaks the fixed-shape contract")
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                d = dotted_name(node.func) or ""
                last = d.rsplit(".", 1)[-1] if d else (
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else "")
                if last not in SORT_CALLS:
                    continue
                head = d.split(".")[0] if d else ""
                torch_call = head == "torch" and d.count(".") == 1
                if not torch_call and not (
                        isinstance(node.func, ast.Attribute)
                        and ctx.tainted(node.func.value, fn)):
                    continue    # host numpy, or not a tensor's sort
                stable = any(k.arg == "stable" and isinstance(
                    k.value, ast.Constant) and k.value.value is True
                    for k in node.keywords)
                if not stable:
                    yield self.finding(
                        ctx, node,
                        f"`{d or last}` in devtree without stable=True: "
                        f"ties would order differently per run")


ALL_RULES: Sequence[Rule] = (
    HostPull(), ImplicitScalar(), DataDependentShape(), PrintInHot(),
    NondeterminismInHot(), SyncOutsideObsGate(), ScatterInDevtree(),
    ShapeOrSortInDevtree(),
)

#: The reference's rules and their twins here (None: no twin, and why).
REFERENCE_TWINS = {
    "TS001": "HS001", "TS002": "HS001", "TS003": "HS002", "TS004": "HS002",
    "TS005": None,    # nothing is jitted: no static arguments
    "TS006": "TS006", "ND001": "ND001", "DV001": "DV001", "DV002": "DV002",
    "OB001": "OB001",
    "DN001": None,    # nothing is donated (donate_charges not carried over)
}


def get_rule(rule_id: str) -> Rule:
    for r in ALL_RULES:
        if r.id == rule_id:
            return r
    raise KeyError(rule_id)


def run_rules(modules: Sequence[ModuleInfo], resolver: HotResolver,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    out: List[Finding] = []
    seen = set()
    engine = TaintEngine(resolver)
    for mod in modules:
        ctx = RuleContext(mod, resolver, engine)
        for rule in (rules or ALL_RULES):
            for f in rule.check(ctx):
                k = (f.path, f.line, f.col, f.rule, f.message)
                if k not in seen:
                    seen.add(k)
                    out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))
