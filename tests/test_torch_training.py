"""The port's training substrate held against `repro` on the CPU:
optimizers, gradient compression, the data pipeline, the train step's
mirrors of `tests/test_training.py`, and the sharding rules.

The optimizers run on the same seeded numpy params and grads on both
sides (f32 leaves within rtol 1e-6; bf16 leaves within one bf16 ulp,
since the cast back can flip at a tie); quantization and batches are
bitwise the reference's; `compressed_psum` runs over a 2-rank gloo group
in a subprocess against the mean of the dequantized payloads;
`resolve_spec` gives the reference's PartitionSpec entries for every
leaf of every FULL config on the production mesh shapes (the reference
side on `jax.sharding.AbstractMesh`, no devices); in the gloo group the
host mesh is a `DeviceMesh` and `make_shardings` gives DTensor
placements over it.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import TokenSource as JTokenSource
from repro.models.config import RULE_SETS as JRULE_SETS
from repro.models.config import resolve_spec as jresolve_spec
from repro.models.api import Model as JModel
from repro.models.layers import decl_logical as jdecl_logical
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.store import Checkpointer, latest_step
from repro_torch.configs import registry
from repro_torch.data.pipeline import Prefetcher, TokenSource
from repro_torch.launch.mesh import MeshShape, make_host_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.lint import runtime as rt
from repro_torch.models.api import Model
from repro_torch.models.config import (RULE_SETS, make_shardings,
                                       resolve_spec, shard_ctx_for_mesh)
from repro_torch.models.layers import (decl_logical, decl_shapes,
                                       materialize, params_from_numpy,
                                       tree_leaves, tree_map)
from repro_torch.optim import compression as comp
from repro_torch.optim.optimizers import (AdamW, Adafactor,
                                          clip_by_global_norm, get_optimizer,
                                          global_norm, opt_state_from_numpy)
from repro_torch.training.step import StepWatchdog, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_leaf_close(got, want, what):
    """f32 within rtol 1e-6; bf16 within one ulp (bit patterns of the
    same sign at most 1 apart)."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, what
        a = got.view(torch.int16).numpy().astype(np.int32)
        b = want.view(np.int16).astype(np.int32)
        assert np.abs(a - b).max() <= 1, (what, np.abs(a - b).max())
        return
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def opt_case(seed):
    """(params, grads) as numpy trees: f32 and bf16 leaves of 1-3 dims."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "stack": (3, 4, 7), "s": (1,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["h"] = {"wb": rng.standard_normal((4, 8)).astype(np.float32)}
    grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(np.float32),
        params)
    to_bf16 = lambda t: dict(t, h={"wb": np.asarray(
        jnp.asarray(t["h"]["wb"]).astype(jnp.bfloat16))})
    return to_bf16(params), to_bf16(grads)


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, warmup=2)),
    ("adamw", dict(lr=3e-3, warmup=1, weight_decay=0.0, clip_norm=0.5)),
    ("adafactor", dict(lr=1e-2, warmup=2)),
    ("adafactor", dict(lr=1e-2, warmup=1, weight_decay=0.05,
                       clip_threshold=0.5)),
])
def test_optimizer_updates_match_reference(name, kw):
    """Three updates on the same params and grads: params, moments and
    the global norm against the reference's."""
    p_np, g_np = opt_case(len(kw))
    jo, po = jopt.get_optimizer(name, **kw), get_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jo.init(jp)
    pp = params_from_numpy(p_np, device="cpu")
    ps = po.init(pp)
    for i in range(3):
        scale = 1.0 + i
        jg = jax.tree.map(lambda g: jnp.asarray(g) * scale, g_np)
        pg = params_from_numpy(np_tree(jg), device="cpu")
        jp, js, jn = jo.update(jg, js, jp)
        pp, ps, pn = po.update(pg, ps, pp)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(np_tree(jp))):
        assert_leaf_close(got, want, f"{name} params")
    for got, want in zip(tree_leaves(ps), jax.tree.leaves(np_tree(js))):
        if want.dtype == np.int32:
            assert got.dtype == torch.int32 and int(got) == int(want) == 3
        else:
            assert_leaf_close(got, want, f"{name} state")


def test_update_is_in_place_and_reads_nothing_to_the_host():
    p_np, g_np = opt_case(0)
    for opt in (AdamW(), Adafactor()):
        p = params_from_numpy(p_np, device="cpu")
        g = params_from_numpy(g_np, device="cpu")
        s = opt.init(p)
        ptrs = [t.data_ptr() for t in tree_leaves((p, s))
                if t.dim() > 0]
        before = rt.sync_counts()
        with rt.no_implicit_syncs("cpu"):
            p2, s2, _ = opt.update(g, s, p)
        assert rt.sync_counts() == before
        assert p2 is p
        assert [t.data_ptr() for t in tree_leaves((p2, s2))
                if t.dim() > 0] == ptrs


def test_clip_and_global_norm_match_reference():
    _, g_np = opt_case(3)
    jg = jax.tree.map(jnp.asarray, g_np)
    pg = params_from_numpy(g_np, device="cpu")
    np.testing.assert_allclose(float(global_norm(pg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.1, 1e3):
        got, gn = clip_by_global_norm(pg, max_norm)
        want, jn = jopt.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_adafactor_state_shapes_and_logical_axes():
    """Factored statistics for ndim >= 2 (the reference's shapes), a full
    one below; state_logical as the reference's, for both optimizers."""
    p_np, _ = opt_case(0)
    st = Adafactor().init(params_from_numpy(p_np, device="cpu"))
    jst = jopt.Adafactor().init(jax.tree.map(jnp.asarray, p_np))
    assert st["fac"]["stack"]["vr"].shape == (3, 4)
    assert st["fac"]["stack"]["vc"].shape == (3, 7)
    assert set(st["fac"]["b"]) == {"v"}
    assert [tuple(t.shape) for t in tree_leaves(st)] == [
        tuple(t.shape) for t in jax.tree.leaves(jst)]
    decls = JModel(jget_config("granite-moe-1b-a400m")).decls()
    logical = decl_logical(Model(registry.get_config(
        "granite-moe-1b-a400m")).decls())
    for ours, theirs in ((AdamW(), jopt.AdamW()),
                         (Adafactor(), jopt.Adafactor())):
        assert ours.state_logical(logical) == theirs.state_logical(
            jdecl_logical(decls))


def test_opt_state_from_numpy_carries_the_references_state():
    p_np, g_np = opt_case(1)
    for name in ("adamw", "adafactor"):
        jo = jopt.get_optimizer(name)
        jp = jax.tree.map(jnp.asarray, p_np)
        _, js, _ = jo.update(jax.tree.map(jnp.asarray, g_np), jo.init(jp), jp)
        st = opt_state_from_numpy(np_tree(js), device="cpu")
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
        for a, b in zip(tree_leaves(st), jax.tree.leaves(np_tree(js))):
            np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="not an AdamW or Adafactor"):
        opt_state_from_numpy({"mu": np.zeros(2)}, device="cpu")


def _quadratic_convergence(opt):
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}  # d/dw of |w|^2
        params, state, _ = opt.update(grads, state, params)
    return float(params["w"].abs().max())


@pytest.mark.parametrize("opt", [AdamW(lr=0.1, weight_decay=0.0, warmup=1),
                                 Adafactor(lr=0.1, warmup=1)],
                         ids=["adamw", "adafactor"])
def test_optimizer_converges_quadratic(opt):
    assert _quadratic_convergence(opt) < 0.05


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def _compression_inputs():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5],
                    np.float32)               # scale 1: x / scale at .5
    return [ties, rng.standard_normal(512).astype(np.float32),
            (rng.standard_normal((16, 8)) * 1e-3).astype(np.float32),
            np.zeros(4, np.float32)]


@pytest.mark.parametrize("case", range(4))
def test_quantize_and_ef_quantize_bitwise(case):
    x = _compression_inputs()[case]
    err = np.random.default_rng(case).standard_normal(x.shape).astype(
        np.float32) * 0.01
    q, s = comp.quantize_int8(torch.as_tensor(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.float32(js)
    np.testing.assert_array_equal(
        comp.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))
    got = comp.ef_quantize(torch.as_tensor(x), torch.as_tensor(err))
    want = jcomp.ef_quantize(jnp.asarray(x), jnp.asarray(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ef_quantization_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal(512).astype(np.float32))
    err = torch.zeros(512)
    q, scale, err1 = comp.ef_quantize(g, err)
    np.testing.assert_allclose(comp.dequantize_int8(q, scale).numpy(),
                               g.numpy(), atol=float(scale) / 2 + 1e-7)
    total, err = torch.zeros(512), torch.zeros(512)
    n = 64
    for _ in range(n):
        q, scale, err = comp.ef_quantize(g * 0.01, err)
        total = total + comp.dequantize_int8(q, scale)
    np.testing.assert_allclose((total / n).numpy(), (g * 0.01).numpy(),
                               atol=2e-4)


_PSUM = r"""
import socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def inputs(rank):
    r = np.random.default_rng(rank)
    return ({"a": torch.as_tensor(r.standard_normal((8, 5)).astype(np.float32)),
             "b": torch.as_tensor(r.standard_normal(7).astype(np.float32))},
            {"a": torch.as_tensor(r.standard_normal((8, 5)).astype(np.float32)) * 1e-2,
             "b": torch.zeros(7)})


def mesh_checks(p):
    # with a group up: the host mesh is a (p, 1) DeviceMesh, the rules
    # give DTensor placements over it, and the launcher trains on it
    import tempfile
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import Model
    from repro_torch.models.config import (RULE_SETS, make_shardings,
                                           mesh_axes, shard_ctx_for_mesh)
    from repro_torch.models.layers import decl_logical, decl_shapes
    mesh = make_host_mesh()
    assert mesh_axes(mesh) == {"data": p, "model": 1}, mesh
    assert shard_ctx_for_mesh(mesh).dp == ("data",)
    decls = Model(get_config("internlm2-1.8b", smoke=True)).decls()
    pl = make_shardings(decl_logical(decls), decl_shapes(decls),
                        RULE_SETS["fsdp_tp"], mesh)
    # embed (vocab, embed): vocab over `model` (1 divides), embed over data
    assert pl["embed"] == (Shard(1), Shard(0)), pl["embed"]
    assert pl["final_norm"]["scale"] == (Shard(0), Replicate())
    tp = make_shardings(decl_logical(decls), decl_shapes(decls),
                        RULE_SETS["tp"], mesh)
    assert tp["final_norm"]["scale"] == (Replicate(), Replicate())
    with tempfile.TemporaryDirectory() as d:
        # the launcher trains on the group's (p, 1) mesh, its parameters
        # DTensors placed by the tp rules
        params = train.main(["--smoke", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--batch", "4", "--ckpt-dir",
                             d])
        leaf = params["final_norm"]["scale"]
        assert tuple(leaf.device_mesh.shape) == (p, 1), leaf
        assert tuple(leaf.placements) == tp["final_norm"]["scale"]


def run(rank, p, port, errors):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=p, rank=rank)
    try:
        from repro_torch.optim import compression as comp
        g, e = inputs(rank)
        mean, new_err = comp.compressed_psum_tree(g, e)
        for k in g:
            parts = [comp.ef_quantize(*(t[k] for t in inputs(r)))
                     for r in range(p)]
            want = sum(comp.dequantize_int8(q, s) for q, s, _ in parts) / p
            torch.testing.assert_close(mean[k], want, rtol=1e-6, atol=1e-7)
            assert torch.equal(new_err[k], parts[rank][2]), k
            # the error feedback: what was lost is carried, exactly
            torch.testing.assert_close(
                comp.dequantize_int8(*parts[rank][:2]) + new_err[k],
                g[k] + e[k], rtol=0, atol=1e-6)
        mesh_checks(p)
    except Exception:
        import traceback
        errors.put(f"rank {rank}: {traceback.format_exc()}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    p = int(sys.argv[1])
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    errors = mp.get_context("spawn").SimpleQueue()
    mp.spawn(run, args=(p, port, errors), nprocs=p)
    if not errors.empty():
        sys.exit(errors.get())
    print("ok")
"""


def test_compressed_psum_and_meshes_over_a_gloo_group(tmp_path):
    script = tmp_path / "psum.py"
    script.write_text(textwrap.dedent(_PSUM))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), "2"],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert proc.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("memmap", [False, True])
def test_batch_at_is_the_references(memmap, tmp_path):
    path = None
    if memmap:
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(5).integers(0, 1000, 5000).astype(
            np.int32).tofile(path)
    a = TokenSource(1000, 16, 4, seed=3, path=path)
    b = JTokenSource(1000, 16, 4, seed=3, path=path)
    for step in (0, 1, 5, 17):
        got, want = a.batch_at(step)["tokens"], b.batch_at(step)["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_shard_for_covers_the_batch():
    a = TokenSource(100, 16, 4, seed=3)
    batch = a.batch_at(0)
    parts = [a.shard_for(batch, r, 4)["tokens"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), batch["tokens"])
    for r in range(2):
        np.testing.assert_array_equal(
            a.shard_for(batch, r, 2)["tokens"],
            JTokenSource(100, 16, 4, seed=3).shard_for(batch, r, 2)["tokens"])


def test_prefetcher_order():
    src = TokenSource(50, 8, 2, seed=1)
    pf, jpf = Prefetcher(src, start_step=3, depth=2), JPrefetcher(
        JTokenSource(50, 8, 2, seed=1), start_step=3, depth=2)
    try:
        for (step, batch), (jstep, jbatch), want in zip(pf, jpf, (3, 4, 5)):
            assert step == jstep == want
            np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(want)["tokens"])
    finally:
        pf.close()
        jpf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# the train step (mirrors of tests/test_training.py)
# ---------------------------------------------------------------------------


def _tiny_setup():
    cfg = registry.get_config("internlm2-1.8b", smoke=True)
    model = Model(cfg)
    params = materialize(model.decls(), 0, device="cpu")
    opt = AdamW(lr=3e-3, warmup=10)
    src = TokenSource(cfg.vocab, seq_len=32, global_batch=8, seed=7)
    return model, params, opt, src, make_train_step(model, opt)


def _batch(src, step):
    return {k: torch.as_tensor(v) for k, v in src.batch_at(step).items()}


def test_loss_decreases():
    model, params, opt, src, step_fn = _tiny_setup()
    state = opt.init(params)
    losses = []
    for step in range(30):
        params, state, metrics = step_fn(params, state, _batch(src, step))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def test_train_step_reads_nothing_to_the_host():
    model, params, opt, src, step_fn = _tiny_setup()
    state = opt.init(params)
    batch = _batch(src, 0)
    before = rt.sync_counts()
    with rt.no_implicit_syncs("cpu"):
        for _ in range(2):
            params, state, m = step_fn(params, state, batch)
    assert rt.sync_counts() == before
    assert set(m) >= {"loss", "grad_norm", "param_norm", "aux_loss"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in m.values())


def test_checkpoint_restart_bitwise(tmp_path):
    """Train 10 steps; crash after 6; resume from the step-5 checkpoint:
    the final params equal the uninterrupted run's bitwise."""
    model, params0, opt, src, step_fn = _tiny_setup()
    ck = Checkpointer(str(tmp_path), keep_last=2)
    clone = lambda t: tree_map(lambda x: x.clone(), t)

    p, s = clone(params0), opt.init(params0)
    for step in range(10):
        p, s, m = step_fn(p, s, _batch(src, step))
    ref_params, ref_loss = p, float(m["loss"])

    p, s = clone(params0), opt.init(params0)
    for step in range(6):
        p, s, m = step_fn(p, s, _batch(src, step))
        if step == 4:
            ck.save(5, {"params": p, "opt": s}, meta={"step": 5},
                    background=True)
    ck.wait()
    assert latest_step(str(tmp_path)) == 5
    restored, step0, meta = ck.restore({"params": p, "opt": s})
    assert meta["step"] == step0 == 5
    p2, s2 = restored["params"], restored["opt"]
    for step in range(5, 10):
        p2, s2, m2 = step_fn(p2, s2, _batch(src, step))
    assert float(m2["loss"]) == ref_loss
    for a, b in zip(tree_leaves(p2), tree_leaves(ref_params)):
        assert torch.equal(a, b)


def test_watchdog_flags_stragglers(monkeypatch):
    """The reference test's steps (eight of 5 ms, then one of 80 ms) on a
    clock of the test's own, so that a loaded machine flags nothing."""
    from repro_torch.training import step as st

    class Clock:
        t = 0.0

        def monotonic(self):
            return self.t

    clock = Clock()
    monkeypatch.setattr(st, "time", clock)
    wd = StepWatchdog(factor=3.0)

    def step(dt):
        wd.start()
        clock.t += dt
        return wd.stop()

    for _ in range(8):
        assert not step(0.005)
    assert not step(0.0149)         # under 3x the median
    assert step(0.08)
    assert wd.flagged == 1


# ---------------------------------------------------------------------------
# sharding rules and meshes
# ---------------------------------------------------------------------------

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_reference(arch, mesh):
    """Every leaf of the FULL config under its arch's rule set (and the
    other one), as the reference's PartitionSpec entries."""
    shape, names = MESHES[mesh]
    ours = MeshShape(shape, names)
    theirs = jax.sharding.AbstractMesh(shape, names)
    decls = Model(registry.get_config(arch)).decls()
    leaves = list(zip(tree_leaves(decl_logical(decls), is_leaf=lambda x:
                                  isinstance(x, tuple)),
                      tree_leaves(decl_shapes(decls))))
    assert len(leaves) == len(jax.tree.leaves(
        JModel(jget_config(arch)).decls()))
    sharded = 0
    for rules in ("tp", "fsdp_tp"):
        specs = make_shardings(decl_logical(decls), decl_shapes(decls),
                               RULE_SETS[rules], ours)
        flat = tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
        for (logical, t), spec in zip(leaves, flat):
            want = tuple(jresolve_spec(logical, tuple(t.shape),
                                       JRULE_SETS[rules], theirs))
            assert resolve_spec(logical, tuple(t.shape), RULE_SETS[rules],
                                ours) == want == spec, (arch, logical)
            sharded += any(e is not None for e in want)
    assert sharded > 0
    ctx = shard_ctx_for_mesh(ours)
    assert ctx.enabled and ctx.tp == "model"
    assert ctx.dp == (("pod", "data") if mesh == "multi" else ("data",))
    x = torch.ones(2, 3)
    assert ctx.constrain(x, "dp", None) is x


def test_meshes_of_one_process():
    mesh = make_host_mesh()
    assert mesh == MeshShape((1, 1), ("data", "model"))
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} devices"):
            make_production_mesh(multi_pod=multi)
