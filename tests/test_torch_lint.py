"""repro_torch.lint: a fires/quiet fixture pair per rule, the hot-function
resolver, suppressions, the baseline and the CLI contract, and the
self-check that the port lints clean with no baseline."""
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.lint import HOT_ROOTS, HotResolver, main
from repro_torch.lint import baseline as bl
from repro_torch.lint.findings import Finding, Severity
from repro_torch.lint.resolver import module_dotted, parse_module
from repro_torch.lint.rules import (ALL_RULES, REFERENCE_TWINS, get_rule,
                                    run_rules)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FIXTURE = "src/repro_torch/core/fixture.py"
DEVTREE = "src/repro_torch/devtree/fixture.py"
OBS = "src/repro_torch/obs/fixture.py"


def _findings(src, path=FIXTURE, hot=("f",)):
    mod = parse_module(path, textwrap.dedent(src))
    roots = [(module_dotted(path), q) for q in hot]
    return run_rules([mod], HotResolver([mod], roots=roots, cold=()))


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------
# rule fixtures: one that fires and one that stays quiet per rule
# ---------------------------------------------------------------------

HS001_FORMS = {
    "item": "x.sum().item()", "tolist": "x.tolist()", "cpu": "x.cpu()",
    "numpy": "x.numpy()", "to_cpu": 'x.to("cpu")',
    "to_device_cpu": 'x.to(device=torch.device("cpu"))',
    "asarray": "np.asarray(x)", "array": "np.array(x)",
}


@pytest.mark.parametrize("form", sorted(HS001_FORMS))
def test_hs001_host_pull_in_hot_fires(form):
    fs = _findings(f"""
        import numpy as np
        import torch

        def f(x):
            return {HS001_FORMS[form]}
    """)
    assert "HS001" in _rules(fs)


def test_hs001_explicit_sync_and_cold_code_quiet():
    fs = _findings("""
        from repro_torch.lint import runtime as _rt

        def f(x):
            with _rt.explicit_sync("drift"):
                return x.sum().item()

        def host_report(x):
            return x.tolist()
    """)
    assert "HS001" not in _rules(fs)


HS002_FORMS = {
    "float": "return float(x)", "int": "return int(x.max())",
    "bool": "return bool(x.any())",
    "if": "if x.sum() > 0:\n        return x\n    return -x",
    "while": "while x.max() > 1:\n        x = x / 2\n    return x",
    "assert": "assert (x >= 0).all()\n    return x",
    "ifexp": "return x if x.sum() else -x",
}


@pytest.mark.parametrize("form", sorted(HS002_FORMS))
def test_hs002_implicit_scalar_fires(form):
    body = HS002_FORMS[form]
    fs = _findings(f"def f(x):\n    {body}\n", hot=("f",))
    assert "HS002" in _rules(fs)


def test_hs002_host_values_quiet():
    fs = _findings("""
        import torch

        def backend(like) -> str:
            return "cuda" if like.is_cuda else "torch"

        def f(x, arrays, counts=None, *, dt: float, mode: str = "diff"):
            n = int(x.shape[0]) + len(arrays)
            if x.dim() == 3 and counts is None:
                n += 1
            if backend(x) == "cuda" and mode == "diff":
                n += 1
            for lane, t in arrays.items():
                if lane == "approx":
                    n += 1
            parts = []
            parts.append(x)
            if parts and float(dt) > 0:
                n += 1
            ok = any(t.dtype == x.dtype for t in arrays.values())
            if ok:
                n += 1
            return x * n
    """)
    assert "HS002" not in _rules(fs)


HS003_FORMS = {
    "nonzero": "x.nonzero()", "where1": "torch.where(x > 0)",
    "mask": "x[x > 0]", "mask_name": "x[m]",
    "masked_select": "x.masked_select(x > 0)", "unique": "x.unique()",
}


@pytest.mark.parametrize("form", sorted(HS003_FORMS))
def test_hs003_data_dependent_shape_fires(form):
    fs = _findings(f"""
        import torch

        def f(x):
            m = torch.isfinite(x) & (x > 0)
            return {HS003_FORMS[form]}
    """)
    assert "HS003" in _rules(fs)


def test_hs003_fixed_shapes_quiet():
    fs = _findings("""
        import torch

        def f(x, idx):
            m = x > 0
            y = torch.where(m, x, torch.zeros_like(x))
            y[m] = 0.0
            return y[idx.clamp(min=0)] + x[:, None].sum(-1)
    """)
    assert "HS003" not in _rules(fs)


def test_ts006_print_in_hot_fires():
    fs = _findings("""
        def f(x):
            print("step")
            return x
    """)
    assert "TS006" in _rules(fs)
    assert all(f.severity == Severity.WARNING for f in fs
               if f.rule == "TS006")


def test_ts006_print_in_host_code_quiet():
    fs = _findings("""
        def f(x):
            return x

        def report(x):
            print(x.shape)
    """)
    assert "TS006" not in _rules(fs)


@pytest.mark.parametrize("call", ["time.perf_counter()", "random.random()",
                                  "np.random.rand(3)", "np.random.seed(0)"])
def test_nd001_nondeterminism_in_hot_fires(call):
    fs = _findings(f"""
        import random
        import time
        import numpy as np

        def f(x):
            return x * {call}
    """)
    assert "ND001" in _rules(fs)


def test_nd001_seeded_and_obs_quiet():
    fs = _findings("""
        import numpy as np

        def f(x):
            return x * np.random.default_rng(0).uniform()
    """)
    assert "ND001" not in _rules(fs)
    fs = _findings("""
        import time

        def f(x):
            return time.perf_counter()
    """, path=OBS)
    assert "ND001" not in _rules(fs)


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()",
                                  "event.synchronize()",
                                  "stream.synchronize()"])
def test_ob001_sync_outside_gate_fires(call):
    fs = _findings(f"""
        import torch

        def step(x, event, stream):
            y = x * 2
            {call}
            return y
    """, hot=())
    assert "OB001" in _rules(fs)


def test_ob001_gated_or_explicit_sync_quiet():
    fs = _findings("""
        import torch
        from repro_torch.obs import trace as _trace
        from repro_torch.lint import runtime as _rt

        _enabled = False

        def a(x):
            if _trace.enabled():
                torch.cuda.synchronize()
            return x

        def b(device):
            if not _enabled:
                return
            torch.cuda.synchronize(device)

        def c(event):
            with _rt.explicit_sync("replan_wait"):
                event.synchronize()
    """, hot=())
    assert "OB001" not in _rules(fs)


@pytest.mark.parametrize("call", [
    "out.scatter_add_(0, idx, x)", "out.index_add_(0, idx, x)",
    "out.index_put_((idx,), x, accumulate=True)",
    'out.scatter_reduce_(0, idx, x, "sum")'])
def test_dv001_accumulating_scatter_in_devtree_fires(call):
    fs = _findings(f"""
        def build(out, idx, x):
            return {call}
    """, path=DEVTREE, hot=())
    assert "DV001" in _rules(fs)


def test_dv001_minmax_and_outside_devtree_quiet():
    src = """
        def build(out, idx, x):
            out.scatter_reduce_(0, idx, x, "amax", include_self=True)
            out.index_put_((idx,), x)
            return out.scatter_(0, idx, x)
    """
    assert "DV001" not in _rules(_findings(src, path=DEVTREE, hot=()))
    assert "DV001" not in _rules(_findings(
        "def f(out, i, x):\n    return out.index_add_(0, i, x)\n", hot=()))


@pytest.mark.parametrize("call", ["torch.sort(codes)",
                                  "torch.argsort(codes)",
                                  "codes.sort()", "codes.nonzero()"])
def test_dv002_unstable_sort_or_shape_in_devtree_fires(call):
    fs = _findings(f"""
        import torch

        def build(codes):
            return {call}
    """, path=DEVTREE, hot=())
    assert "DV002" in _rules(fs)


def test_dv002_stable_sort_quiet():
    fs = _findings("""
        import numpy as np
        import torch

        class Build:
            def sort(self, block):
                return block

            def run(self, codes):
                self.sort(block=True)
                host = np.argsort(np.zeros(3), kind="stable")
                return torch.sort(codes, stable=True)[1], host
    """, path=DEVTREE, hot=())
    assert "DV002" not in _rules(fs)


def test_every_rule_has_a_fixture_pair():
    """The fixtures above cover the full registry, and every reference
    rule has a twin or a stated reason for none."""
    covered = {"HS001", "HS002", "HS003", "TS006", "ND001", "OB001",
               "DV001", "DV002"}
    assert {r.id for r in ALL_RULES} == covered
    for rid in covered:
        assert get_rule(rid).description
    from repro.lint.rules import ALL_RULES as REF_RULES
    assert set(REFERENCE_TWINS) == {r.id for r in REF_RULES}
    assert {v for v in REFERENCE_TWINS.values() if v} <= covered
    assert [k for k, v in REFERENCE_TWINS.items() if v is None] == [
        "TS005", "DN001"]


# ---------------------------------------------------------------------
# the hot-function resolver
# ---------------------------------------------------------------------


def _resolve(src, roots, cold=(), path=FIXTURE):
    mod = parse_module(path, textwrap.dedent(src))
    dotted = module_dotted(path)
    r = HotResolver([mod], roots=[(dotted, q) for q in roots],
                    cold=[(dotted, q) for q in cold])
    return {f.local_qualname: f for f in mod.functions}, r


def test_hot_roots_table_resolves_in_the_port():
    from repro_torch.lint.resolver import scan_paths
    r = HotResolver(scan_paths([PORT]))
    assert not r.missing_roots, r.missing_roots
    roots = {f.local_qualname for f in r.hot_functions() if f.is_root}
    assert len(roots) == len(HOT_ROOTS)
    assert {"Simulation.step", "_execute_impl", "batch_cluster_eval",
            "sharded_sweep", "EnsembleMD.step",
            "_PhiFromTargets.backward"} <= roots


def test_call_graph_propagation_and_cold_boundary():
    fns, _ = _resolve("""
        def helper(x):
            return leaf(x)

        def leaf(x):
            return x

        def rebuild(x):
            return x.cpu()

        def unrelated(x):
            return x

        class Engine:
            def step(self, x):
                self._inner(x)
                rebuild(x)
                return helper(x)

            def _inner(self, x):
                return x
    """, roots=["Engine.step"], cold=["rebuild"])
    assert fns["Engine.step"].is_root
    assert fns["helper"].traced and fns["leaf"].traced
    assert fns["Engine._inner"].traced         # self.m resolution
    assert "called from" in fns["leaf"].trace_via
    assert not fns["rebuild"].traced           # cold boundary
    assert not fns["unrelated"].traced


def test_closures_of_hot_functions_are_hot():
    fns, _ = _resolve("""
        def make(x):
            def inner(y):
                return y.item()
            return inner

        def outer(x):
            def body(y):
                return y
            return body(x)
    """, roots=["outer"])
    assert fns["outer.<locals>.body"].traced
    assert "nested in" in fns["outer.<locals>.body"].trace_via
    assert not fns["make.<locals>.inner"].traced


def test_common_method_names_do_not_link():
    fns, _ = _resolve("""
        class Log:
            def update(self, x):
                return x.tolist()

        def f(d, x):
            d.update(x)
            return x
    """, roots=["f"])
    assert not fns["Log.update"].traced


# ---------------------------------------------------------------------
# suppressions, baseline, CLI
# ---------------------------------------------------------------------


def _run_cli(args):
    out = io.StringIO()
    return main(list(args), out=out), out.getvalue()


def test_suppression_with_reason_silences(tmp_path):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent("""
        import torch

        def build(out, idx, x):
            # lint: disable=DV001 — integer counts: exact in any order
            return out.index_add_(0, idx, x)
    """))
    d = tmp_path / "devtree"
    d.mkdir()
    (d / "fixture.py").write_text(p.read_text())
    code, out = _run_cli([str(d)])
    assert code == 0, out


def test_suppression_without_reason_is_sup001(tmp_path):
    d = tmp_path / "devtree"
    d.mkdir()
    (d / "fixture.py").write_text(textwrap.dedent("""
        def build(out, idx, x):
            return out.index_add_(0, idx, x)  # lint: disable=DV001
    """))
    code, out = _run_cli([str(d), "--format", "json"])
    assert code == 1
    rules = {f["rule"] for f in json.loads(out)["findings"]}
    assert rules == {"SUP001"}


def test_cli_exit_codes_and_formats(tmp_path):
    d = tmp_path / "devtree"
    d.mkdir()
    (d / "bad.py").write_text("def f(o, i, x):\n"
                              "    return o.index_add_(0, i, x)\n")
    (tmp_path / "good.py").write_text("def g(x):\n    return x\n")
    assert _run_cli([str(tmp_path / "good.py")])[0] == 0
    code, out = _run_cli([str(d), "--format", "gh"])
    assert code == 1 and out.startswith("::error file=")
    assert "title=DV001::" in out
    code, out = _run_cli([str(d), "--format", "json"])
    assert code == 1
    js = json.loads(out)
    assert js["errors"] == 1 and js["findings"][0]["rule"] == "DV001"
    assert _run_cli(["--no-such-flag"])[0] == 2


def test_finding_text_matches_the_reference():
    """One synthetic finding printed by both linters reads the same."""
    from repro.lint import cli as ref_cli
    from repro.lint.findings import Finding as RefFinding
    from repro_torch.lint import cli as port_cli
    kw = dict(rule="HS001", severity="error", path="src/x.py", line=3,
              col=5, message="`.item()` pulls to the host",
              context="hot via HOT_ROOTS x.f")
    ours, theirs = Finding(**kw), RefFinding(**kw)
    assert ours.format_text() == theirs.format_text()
    assert ours.format_gh() == theirs.format_gh()
    assert ours.to_dict() == theirs.to_dict()
    for fmt in ("text", "gh", "json"):
        a, b = io.StringIO(), io.StringIO()
        port_cli._emit([ours], fmt, a)
        ref_cli._emit([theirs], fmt, b)
        assert a.getvalue() == b.getvalue()


def test_baseline_round_trip_and_empty_scope(tmp_path):
    fs = [Finding("HS001", "error", "src/repro_torch/a.py", 1, 1, "m"),
          Finding("HS001", "error", "src/repro_torch/a.py", 9, 1, "m"),
          Finding("OB001", "error", "src/repro_torch/b.py", 2, 1, "m")]
    path = str(tmp_path / "b.json")
    written = bl.write_baseline(path, fs)
    assert bl.load_baseline(path) == written == {
        "src/repro_torch/a.py": {"HS001": 2},
        "src/repro_torch/b.py": {"OB001": 1}}
    assert bl.apply_baseline(fs, written) == []
    assert bl.apply_baseline(fs, {"src/repro_torch/a.py": {"HS001": 1}}) \
        == fs[1:]
    assert bl.BASELINE_SCOPE == ()
    assert bl.check_scope(written) == sorted(written)
    # any entry is a usage error; so is writing one
    code, _ = _run_cli([PORT, "--baseline", path])
    assert code == 2
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert _run_cli([PORT, "--baseline", str(empty)])[0] == 0
    d = tmp_path / "devtree"
    d.mkdir()
    (d / "bad.py").write_text("def f(o, i, x):\n"
                              "    return o.index_add_(0, i, x)\n")
    code, _ = _run_cli([str(d), "--write-baseline",
                        str(tmp_path / "w.json")])
    assert code == 2 and not (tmp_path / "w.json").exists()


# ---------------------------------------------------------------------
# self-check: the port lints clean
# ---------------------------------------------------------------------


def test_port_lints_clean_from_the_command_line():
    """`python -m repro_torch.lint src/repro_torch` exits 0, no baseline."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.lint",
                        "src/repro_torch"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    assert p.stdout.strip().endswith("0 finding(s), 0 error(s)")


def test_summary_counts_hot_functions_and_suppressions():
    code, out = _run_cli([PORT, "--summary"])
    js = json.loads(out)
    assert code == 0 and js["findings"] == 0
    assert js["hot_functions"] >= len(HOT_ROOTS)
    assert js["suppressions"] >= 1


def test_list_hot_names_the_steady_entry_points():
    code, out = _run_cli([PORT, "--list-hot"])
    assert code == 0
    assert "_execute_impl" in out and "Simulation.step" in out
    assert "prepare_plan " not in out and "build_tree" not in out
