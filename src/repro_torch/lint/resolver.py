"""Hot-function resolver: which functions run in the port's steady loops.

Port of `repro/lint/resolver.py`. The reference's roots are the places
JAX traces (``jax.jit``, ``shard_map``, ``pallas_call``, ``@traced``).
The port runs eagerly and has no such marker, so its roots are one
table, `HOT_ROOTS`: the steady entry points whose every call must leave
the card's queue running (an MD refit step, a warm execute or force
call, an ensemble call, the differentiable executor, the sharded sweep,
the kernel entries of `kernels/ops.py`, an LM decode step). `COLD` names the calls out of
them that are host work by contract (a rebuild, a checkpoint): the
closure stops there.

Call-graph edges are resolved conservatively, as in the reference:

- bare names: lexical scope chain, then module functions, then
  from-imports into other scanned modules;
- ``self.m(...)`` / ``cls.m(...)``: methods of the enclosing class;
- ``alias.f(...)`` where ``alias`` imports a scanned module: that
  module's top-level ``f``;
- ``obj.m(...)`` otherwise: every scanned class method named ``m``,
  but only when the name is specific: at most `ATTR_CANDIDATE_CAP`
  candidate definitions and not in `COMMON_METHOD_NAMES`.

The hot set is the BFS closure of the roots over these edges; every
function lexically nested inside a hot function is hot too. Rules get,
per hot function, the chain of resolution (`trace_via`) as evidence.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: The steady entry points: (dotted module, qualname in the module).
HOT_ROOTS: Tuple[Tuple[str, str], ...] = (
    # the MD engine's step and the closures it runs
    ("repro_torch.dynamics.engine", "Simulation.step"),
    ("repro_torch.dynamics.engine",
     "Simulation._make_closures.<locals>.advance"),
    ("repro_torch.dynamics.engine",
     "Simulation._make_closures.<locals>.evaluate"),
    ("repro_torch.dynamics.engine",
     "Simulation._make_closures.<locals>.finish"),
    # the executors
    ("repro_torch.core.eval", "_execute_impl"),
    ("repro_torch.core.eval", "potential_and_gradient"),
    ("repro_torch.core.eval", "ensemble_execute"),
    ("repro_torch.core.eval", "ensemble_potential_and_forces"),
    ("repro_torch.core.eval", "_PhiFromTargets.forward"),
    ("repro_torch.core.eval", "_PhiFromTargets.backward"),
    ("repro_torch.distributed.bltc", "sharded_sweep"),
    ("repro_torch.serve.batched", "EnsembleMD.step"),
    # the kernel entries
    ("repro_torch.kernels.ops", "batch_cluster_eval"),
    ("repro_torch.kernels.ops", "batch_cluster_field"),
    ("repro_torch.kernels.ops", "batch_cluster_field_grid"),
    ("repro_torch.kernels.ops", "modified_charges"),
    ("repro_torch.kernels.ops", "modified_charges_ranged"),
    ("repro_torch.kernels.ops", "modified_charges_transpose_ranged"),
    # refit and slacks, per step
    ("repro_torch.kernels.ops", "refreshed_slacks"),
    ("repro_torch.dynamics.refit", "refit_single_arrays"),
    ("repro_torch.dynamics.refit", "refit_sharded_arrays"),
    ("repro_torch.dynamics.refit", "refresh_slacks_single"),
    ("repro_torch.dynamics.refit", "refresh_slacks_sharded"),
    ("repro_torch.dynamics.refit", "max_drift"),
    ("repro_torch.dynamics.refit",
     "SingleDeviceAdapter.slack_fn.<locals>.slack"),
    ("repro_torch.dynamics.refit",
     "SingleDeviceAdapter.force_fn.<locals>.force"),
    ("repro_torch.dynamics.refit", "ShardedAdapter.slack_fn.<locals>.slack"),
    ("repro_torch.dynamics.refit", "ShardedAdapter.force_fn.<locals>.force"),
    # the LM serving loop's step
    ("repro_torch.models.api", "Model.decode"),
)

#: Calls out of hot code that are host work by contract: the closure
#: does not enter them. A rebuild (host or device), its commit, a
#: checkpoint and the one-time kernel build wait for the host by design;
#: the runtime guard and its `explicit_sync` counts hold them instead.
COLD: Tuple[Tuple[str, str], ...] = (
    ("repro_torch.dynamics.refit", "PlanAdapter.rebuild"),
    ("repro_torch.dynamics.refit", "SingleDeviceAdapter.rebuild"),
    ("repro_torch.dynamics.refit", "ShardedAdapter.rebuild"),
    ("repro_torch.dynamics.refit", "PlanAdapter.rebuild_dispatch"),
    ("repro_torch.dynamics.refit", "SingleDeviceAdapter.rebuild_dispatch"),
    ("repro_torch.dynamics.refit", "PlanAdapter.rebuild_commit"),
    ("repro_torch.dynamics.refit", "SingleDeviceAdapter.rebuild_commit"),
    ("repro_torch.dynamics.engine", "Simulation._rebuild"),
    ("repro_torch.dynamics.engine", "Simulation._swap_plan"),
    ("repro_torch.dynamics.engine", "Simulation.save_checkpoint"),
    ("repro_torch.kernels._build", "build"),
)

# Attribute-call resolution guards (see module docstring).
ATTR_CANDIDATE_CAP = 4
COMMON_METHOD_NAMES = {
    "get", "items", "keys", "values", "append", "extend", "update",
    "copy", "pop", "add", "remove", "clear", "join", "split", "strip",
    "format", "replace", "sort", "setdefault", "record", "count",
    "stats", "close", "write", "read", "put", "run",
}


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    qualname: str            # "<path>::Outer.<locals>.inner"
    name: str
    path: str
    node: ast.AST            # FunctionDef / AsyncFunctionDef
    line: int
    class_name: Optional[str]
    parent: Optional["FunctionInfo"]
    params: Tuple[str, ...]     # positional params then kwonly params
    n_positional: int = 0
    is_root: bool = False
    root_via: Optional[str] = None
    traced: bool = False        # hot (the reference's name, kept)
    trace_via: Optional[str] = None
    # resolved call sites reaching this function from hot callers:
    # (caller, Call node); rules use them for inter-procedural taint
    call_sites: List[Tuple["FunctionInfo", ast.Call]] = dataclasses.field(
        default_factory=list)

    @property
    def local_qualname(self) -> str:
        return self.qualname.split("::", 1)[1]


@dataclasses.dataclass
class ModuleInfo:
    path: str                # as given (relative to cwd in the CLI)
    tree: ast.Module
    source: str
    lines: List[str]
    # import alias -> dotted module ("np" -> "numpy")
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    # from-import local name -> (module, attr)
    from_imports: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    functions: List[FunctionInfo] = dataclasses.field(default_factory=list)

    def numpy_aliases(self) -> Set[str]:
        return {a for a, m in self.imports.items() if m == "numpy"} | {
            a for a, (m, attr) in self.from_imports.items()
            if m == "numpy" and attr == "*"}


def _collect_imports(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                mod.imports[al.asname or al.name.split(".")[0]] = al.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for al in node.names:
                mod.from_imports[al.asname or al.name] = (node.module,
                                                          al.name)


def parse_module(path: str, source: Optional[str] = None) -> ModuleInfo:
    if source is None:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    tree = ast.parse(source, filename=path)
    mod = ModuleInfo(path=path, tree=tree, source=source,
                     lines=source.splitlines())
    _collect_imports(mod)
    _index_functions(mod)
    return mod


def scan_paths(paths: Sequence[str]) -> List[ModuleInfo]:
    """Parse every ``.py`` file under the given files/directories."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
        elif p.endswith(".py"):
            files.append(p)
    mods = []
    for f in sorted(set(files)):
        try:
            mods.append(parse_module(f))
        except SyntaxError:
            continue  # not our job; leave to the interpreter
    return mods


def module_dotted(path: str) -> str:
    """Dotted module name of `path`: the package chain (directories with
    an ``__init__.py``) for a file on disk, else the path with a leading
    ``src/`` dropped (fixtures parsed from strings)."""
    p = os.path.normpath(path)
    if os.path.isfile(p):
        parts = [os.path.splitext(os.path.basename(p))[0]]
        d = os.path.dirname(os.path.abspath(p))
        while os.path.isfile(os.path.join(d, "__init__.py")):
            parts.append(os.path.basename(d))
            d = os.path.dirname(d)
        out = ".".join(reversed(parts))
    else:
        out = p.replace("\\", "/").rsplit(".py", 1)[0].replace("/", ".")
        out = out[4:] if out.startswith("src.") else out
    return out[:-len(".__init__")] if out.endswith(".__init__") else out


def _index_functions(mod: ModuleInfo) -> None:
    """Fill mod.functions with qualnames, class and nesting context."""

    def visit(node, qual_prefix, class_name, parent):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{qual_prefix}.{child.name}" if qual_prefix
                        else child.name)
                pos = [a.arg for a in (child.args.posonlyargs
                                       + child.args.args)]
                params = tuple(pos + [a.arg
                                      for a in child.args.kwonlyargs])
                info = FunctionInfo(
                    qualname=f"{mod.path}::{qual}", name=child.name,
                    path=mod.path, node=child, line=child.lineno,
                    class_name=class_name, parent=parent, params=params,
                    n_positional=len(pos))
                mod.functions.append(info)
                visit(child, f"{qual}.<locals>", class_name, info)
            elif isinstance(child, ast.ClassDef):
                qual = (f"{qual_prefix}.{child.name}" if qual_prefix
                        else child.name)
                visit(child, qual, child.name, parent)
            else:
                visit(child, qual_prefix, class_name, parent)

    visit(mod.tree, "", None, None)


class HotResolver:
    """Mark the roots' functions hot and close over the call graph.

    `roots` / `cold` default to `HOT_ROOTS` / `COLD`; tests pass their
    own tables for fixture modules."""

    def __init__(self, modules: Sequence[ModuleInfo],
                 roots: Sequence[Tuple[str, str]] = HOT_ROOTS,
                 cold: Sequence[Tuple[str, str]] = COLD):
        self.modules = list(modules)
        self.by_path: Dict[str, ModuleInfo] = {m.path: m for m in modules}
        self.module_dotted: Dict[str, str] = {
            m.path: module_dotted(m.path) for m in modules}
        self.dotted_to_mod = {d: self.by_path[p]
                              for p, d in self.module_dotted.items()}
        self.methods: Dict[str, List[FunctionInfo]] = {}
        for m in modules:
            for fn in m.functions:
                if fn.class_name is not None and fn.parent is None:
                    self.methods.setdefault(fn.name, []).append(fn)
        self.roots = tuple(roots)
        self._cold = {id(f) for f in (self._lookup(m, q) for m, q in cold)
                      if f is not None}
        self.missing_roots: List[Tuple[str, str]] = []
        self._find_roots()
        self._propagate()

    # -- roots ---------------------------------------------------------

    def _lookup(self, module: str, qualname: str) -> Optional[FunctionInfo]:
        mod = self.dotted_to_mod.get(module)
        if mod is None:
            return None
        for fn in mod.functions:
            if fn.local_qualname == qualname:
                return fn
        return None

    def _find_roots(self) -> None:
        for module, qualname in self.roots:
            fn = self._lookup(module, qualname)
            if fn is None:
                if module in self.dotted_to_mod:
                    self.missing_roots.append((module, qualname))
                continue
            fn.is_root = True
            fn.root_via = f"HOT_ROOTS {module}.{qualname}"

    # -- reference/call resolution --------------------------------------

    def _imported_module(self, mod: ModuleInfo,
                         alias: str) -> Optional[ModuleInfo]:
        dotted = mod.imports.get(alias)
        if dotted is None and alias in mod.from_imports:
            src, attr = mod.from_imports[alias]
            dotted = f"{src}.{attr}"
        if dotted is None:
            return None
        return self.dotted_to_mod.get(dotted)

    def _module_level(self, mod: ModuleInfo,
                      name: str) -> Optional[FunctionInfo]:
        for fn in mod.functions:
            if fn.name == name and fn.parent is None \
                    and fn.class_name is None:
                return fn
        return None

    def _resolve_name(self, mod: ModuleInfo, name: str,
                      at_node) -> Optional[FunctionInfo]:
        """Lexical: enclosing functions' local defs, then module level,
        then from-imports into scanned modules."""
        line = getattr(at_node, "lineno", 0)
        enclosing = [f for f in mod.functions
                     if f.node.lineno <= line
                     <= max(f.node.lineno,
                            getattr(f.node, "end_lineno", f.node.lineno))]
        enclosing.sort(key=lambda f: f.node.lineno)
        for outer in reversed(enclosing):
            for fn in mod.functions:
                if fn.parent is outer and fn.name == name:
                    return fn
        top = self._module_level(mod, name)
        if top is not None:
            return top
        if name in mod.from_imports:
            src, attr = mod.from_imports[name]
            tmod = self.dotted_to_mod.get(src)
            if tmod is not None:
                return self._module_level(tmod, attr)
        return None

    def resolve_call(self, mod: ModuleInfo, caller: FunctionInfo,
                     call: ast.Call) -> List[FunctionInfo]:
        """Best-effort callee set for one call site (see module doc)."""
        func = call.func
        if isinstance(func, ast.Name):
            t = self._resolve_name(mod, func.id, call)
            return [t] if t is not None else []
        if isinstance(func, ast.Attribute):
            base = func.value
            meth = func.attr
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and caller.class_name:
                    for fn in self.methods.get(meth, []):
                        if (fn.class_name == caller.class_name
                                and fn.path == mod.path):
                            return [fn]
                tmod = self._imported_module(mod, base.id)
                if tmod is not None:
                    t = self._module_level(tmod, meth)
                    return [t] if t is not None else []
            if meth in COMMON_METHOD_NAMES:
                return []
            cands = self.methods.get(meth, [])
            if 0 < len(cands) <= ATTR_CANDIDATE_CAP:
                return list(cands)
        return []

    # -- propagation -----------------------------------------------------

    def _propagate(self) -> None:
        queue: List[FunctionInfo] = []
        for mod in self.modules:
            for fn in mod.functions:
                if fn.is_root:
                    fn.traced = True
                    fn.trace_via = fn.root_via
                    queue.append(fn)
        children: Dict[int, List[FunctionInfo]] = {}
        for mod in self.modules:
            for fn in mod.functions:
                if fn.parent is not None:
                    children.setdefault(id(fn.parent), []).append(fn)
        while queue:
            fn = queue.pop()
            for kid in children.get(id(fn), []):
                if not kid.traced:
                    kid.traced = True
                    kid.trace_via = f"nested in {fn.qualname}"
                    queue.append(kid)
            mod = self.by_path[fn.path]
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in self.resolve_call(mod, fn, node):
                    if id(callee) in self._cold:
                        continue
                    callee.call_sites.append((fn, node))
                    if not callee.traced:
                        callee.traced = True
                        callee.trace_via = (f"called from {fn.qualname}:"
                                            f"{node.lineno}")
                        queue.append(callee)

    # -- queries ---------------------------------------------------------

    def hot_functions(self) -> List[FunctionInfo]:
        return [fn for mod in self.modules for fn in mod.functions
                if fn.traced]


SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}
