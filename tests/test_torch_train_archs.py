"""Training the LM architectures on the port, held against `repro` on
the CPU at their SMOKE configs (f32): here the decoder-only transformers
(dense and MoE); `tests/test_torch_train_archs_mixers.py` runs the same
tests on the SSM, hybrid, encoder-decoder and VLM archs.

The reference's parameters (`repro.models.layers.materialize`) are
carried to the port by `params_from_numpy` and both sides take the same
numpy batch. Per arch: `loss_and_grads` against
`jax.value_and_grad(model.loss, has_aux=True)` (loss rtol 1e-5, each grad
leaf within a relative 2-norm of 1e-5); three AdamW train steps against
the reference's (its value_and_grad and AdamW update, as its
`make_train_step` runs them at grad_accum 1), each also from the
reference's previous params and state (`opt_state_from_numpy`): each
param leaf within 1e-5 on its determined entries (below); grad_accum 4
against 1 (the reference test's bounds: loss 1e-5, params 5e-5); remat
off, on and "dots" giving the same grads. Besides: the fused CE's grads against the dense CE's and the
reference's, and the unbind of a stacked leaf.

Determined entries: AdamW moves an entry by about lr g / (|g| + eps),
whose sensitivity to the gradient is lr eps / (|g| + eps)^2, and f32
gradients carry a rounding of ~1e-6 of a leaf's gradient (the order of
their sums), so an entry whose clipped gradient falls below 1000 eps =
1e-5 at some step moves by an amount that the f32 arithmetic does not
fix to 1e-5 of a small leaf's step, on either side (chatglm's k bias on
its unrotated half-dims has an exact gradient of 0: its reference update
is noise times lr). Such entries are held to a step's reach |dp| <= 3 lr
(1 + weight decay |p|), a sign flip of an Adam step (|u| <= 1.5),
instead of to the leaf's relative 2-norm. `chip_smoke.py` 17a holds the
card to the CPU the same way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.models.api import Model as JModel
from repro.models.config import ModelConfig as JConfig
from repro.optim.optimizers import AdamW as JAdamW
from repro_torch.configs import registry
from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (params_from_numpy, tree_leaves,
                                       tree_map, unstack)
from repro_torch.optim.optimizers import AdamW, opt_state_from_numpy
from repro_torch.training.step import loss_and_grads, make_train_step

BATCH, SEQ = 4, 16
REL = 1e-5
OPT = dict(lr=1e-3, warmup=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def leaves_close(got, want, bound, what):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    worst = max(rel2(g.detach().numpy(), np.asarray(w))
                for g, w in zip(got, want))
    assert worst <= bound, (what, worst)
    return worst


NOISE = 1e-5       # 1000 x AdamW's eps: an update below it is not fixed


def step_close(got, want, noisy, bound, what):
    """Each param leaf of one step within `bound` (relative 2-norm) on its
    determined entries; the undetermined ones (`noisy`) within a step's
    reach."""
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) == len(noisy), what
    worst = 0.0
    for g, w, m in zip(got, want, noisy):
        g, w = g.detach().numpy().astype(np.float64), np.asarray(w, np.float64)
        worst = max(worst, rel2(g[~m], w[~m]))
        reach = 3 * OPT["lr"] * (1 + 0.1 * np.abs(w[m]).max(initial=0))
        assert np.abs(g[m] - w[m]).max(initial=0) <= reach, what
    assert worst <= bound, (what, worst)
    return worst


def noisy_entries(grads_per_step):
    """Per leaf, the entries whose clipped gradient falls below NOISE at
    some step (clip_norm 1)."""
    masks = None
    for grads in grads_per_step:
        leaves = jax.tree.leaves(grads)
        gn = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                         for g in leaves))
        scale = min(1.0, 1.0 / max(gn, 1e-9))
        small = [np.abs(g) * scale < NOISE for g in leaves]
        masks = small if masks is None else [a | b for a, b in
                                             zip(masks, small)]
    return masks


def make_batch(cfg, seed):
    """Numpy batch of BATCH x (SEQ + 1) tokens and the stub inputs."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ + 1))
         .astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (BATCH, cfg.src_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    return b


def tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def smoke_configs(arch):
    """(reference config, port config) at SMOKE, a MoE arch's dispatch
    groups one batch row each (moe_group = SEQ), so that a microbatch of
    grad_accum routes its tokens as the whole batch does."""
    jcfg, cfg = jget_config(arch, smoke=True), registry.get_config(
        arch, smoke=True)
    if cfg.n_experts:
        jcfg = dataclasses.replace(jcfg, moe_group=SEQ)
        cfg = dataclasses.replace(cfg, moe_group=SEQ)
    return jcfg, cfg


TRANSFORMERS = tuple(a for a in ARCH_IDS
                     if jget_config(a, smoke=True).family in ("dense", "moe"))


@pytest.fixture(scope="module", params=TRANSFORMERS)
def arch(request):
    return arch_case(request.param)


def arch_case(arch):
    """Per arch: the reference's grads and its params and state after
    each of three AdamW steps on batches 0-2."""
    jcfg, cfg = smoke_configs(arch)
    jmodel = JModel(jcfg)
    jparams = jl.materialize(jmodel.decls(), jax.random.key(3))
    batches = [make_batch(cfg, 10 + i) for i in range(3)]
    opt = JAdamW(**OPT)

    def ref_step(p, s, b):
        """The reference's train step (make_train_step at grad_accum 1:
        value_and_grad, then the update), its loss and grads kept."""
        (loss, _), g = jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)
        p, s, _ = opt.update(g, s, p)
        return loss, g, p, s

    step = jax.jit(ref_step)
    p, s, trail, seen = jparams, opt.init(jparams), [], []
    for b in batches:
        loss, g, p, s = step(p, s, jbatch(b))
        seen.append(jax.tree.map(np.asarray, g))
        trail.append((jax.tree.map(np.asarray, p),
                      jax.tree.map(np.asarray, s), float(loss)))
    return dict(arch=arch, cfg=cfg, batches=batches,
                params=jax.tree.map(np.asarray, jparams),
                loss=trail[0][2], grads=seen[0], trail=trail,
                noisy=noisy_entries(seen))


def port_params(arch):
    return params_from_numpy(arch["params"], device="cpu")


def test_loss_and_grads_match_reference(arch):
    model = Model(arch["cfg"])
    (loss, metrics), grads = loss_and_grads(
        model, port_params(arch), tbatch(arch["batches"][0]))
    np.testing.assert_allclose(float(loss), arch["loss"], rtol=REL)
    assert not loss.requires_grad and "loss" in metrics
    for g, p in zip(tree_leaves(grads), tree_leaves(port_params(arch))):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert bool(torch.isfinite(g).all())
    leaves_close(grads, arch["grads"], REL, f"{arch['arch']} grads")


def _step_from(arch, t):
    """The port's train step t (0-2) from the reference's params and
    AdamW state after step t - 1 (the port's own init at t = 0)."""
    opt = AdamW(**OPT)
    if t:
        jp, js, _ = arch["trail"][t - 1]
        p = params_from_numpy(jp, device="cpu")
        s = opt_state_from_numpy(js, device="cpu")
    else:
        p = port_params(arch)
        s = opt.init(p)
    return make_train_step(Model(arch["cfg"]), opt)(
        p, s, tbatch(arch["batches"][t]))


def test_three_train_steps_match_reference(arch):
    """Three steps chained on the port: each step's loss the reference's
    (rtol 1e-5). Each step also from the reference's previous params and
    state: the params per leaf within 1e-5 on their determined entries,
    the first moments within 1e-5, the second within 2e-5 (an EMA of g^2
    carries twice g's relative error). Chained params are not held per
    leaf: an undetermined entry's step (up to 2 lr) moves the next
    step's gradients, and the zero-initialized leaves (biases, A_log,
    dt_bias), whose size is a few lr, drift by ~1e-5 of it."""
    opt = AdamW(**OPT)
    step = make_train_step(Model(arch["cfg"]), opt)
    p = port_params(arch)
    s = opt.init(p)
    for t, (b, (jp, js, jloss)) in enumerate(zip(arch["batches"],
                                                  arch["trail"])):
        p, s, m = step(p, s, tbatch(b))
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=REL)
        tp, ts, tm = _step_from(arch, t)
        np.testing.assert_allclose(float(tm["loss"]), jloss, rtol=REL)
        step_close(tp, jp, arch["noisy"], REL, f"{arch['arch']} step {t}")
        leaves_close(ts["m"], js["m"], REL, f"{arch['arch']} m {t}")
        leaves_close(ts["v"], js["v"], 2 * REL, f"{arch['arch']} v {t}")
        assert int(ts["step"]) == t + 1


def test_step_from_the_references_optimizer_state(arch):
    """The reference's params and AdamW state after two steps, carried
    across (`opt_state_from_numpy`), then the port's third step: its
    state is the port's own (f32 moments, an int32 step, updated in
    place) and its params the reference's third."""
    p, s, _ = _step_from(arch, 2)
    want_p, want_s, _ = arch["trail"][2]
    step_close(p, want_p, arch["noisy"], REL, f"{arch['arch']} params")
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 3
    assert all(t.dtype == torch.float32 for t in tree_leaves(s["m"]))
    assert [tuple(t.shape) for t in tree_leaves(s["v"])] == [
        tuple(t.shape) for t in tree_leaves(p)]


def test_grad_accum_equals_full_batch(arch):
    cfg = arch["cfg"]
    opt = AdamW(lr=1e-3, warmup=1)
    batch = tbatch(arch["batches"][0])
    out = []
    for accum in (1, 4):
        model = Model(dataclasses.replace(cfg, grad_accum=accum))
        p = port_params(arch)
        out.append(make_train_step(model, opt)(p, opt.init(p), batch))
    (p1, _, m1), (p4, _, m4) = out
    assert float(torch.abs(m1["loss"] - m4["loss"])) < 1e-5
    d = max(float(torch.max(torch.abs(a - b)))
            for a, b in zip(tree_leaves(p1), tree_leaves(p4)))
    assert d < 5e-5


def test_remat_gives_the_same_grads(arch):
    """remat off, on with "nothing" and on with "dots": equal losses and
    grads (the recomputed forward is the same operations)."""
    batch = tbatch(arch["batches"][0])
    outs = []
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        cfg = dataclasses.replace(arch["cfg"], remat=remat,
                                  remat_policy=policy)
        outs.append(loss_and_grads(Model(cfg), port_params(arch), batch))
    (l0, _), g0 = outs[0]
    for (l, _), g in outs[1:]:
        assert float(l) == float(l0)
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# pieces
# --------------------------------------------------------------------------


def _tiny(cls=ModelConfig, **kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, remat=False)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("remat", [False, True])
def test_fused_ce_grads_match_dense_and_reference(remat):
    """ce_chunk = 8 (each chunk checkpointed): grads equal to the dense
    CE's on the port and to the reference's fused CE grads."""
    jcfg = _tiny(JConfig, ce_chunk=8, remat=remat)
    jp = jl.materialize(jtf.lm_decls(jcfg), jax.random.key(0))
    toks = np.random.default_rng(2).integers(0, 64, (4, 33)).astype(np.int32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    fused, dense = (Model(_tiny(ce_chunk=c, remat=remat)) for c in (8, 0))
    (lf, _), gf = loss_and_grads(fused, params, {"tokens": torch.as_tensor(
        toks)})
    (ld, _), gd = loss_and_grads(dense, params, {"tokens": torch.as_tensor(
        toks)})
    np.testing.assert_allclose(float(lf), float(jloss), rtol=REL)
    assert abs(float(lf) - float(ld)) < 1e-5
    leaves_close(gf, jax.tree.map(np.asarray, jg), REL, "fused vs reference")
    for a, b in zip(tree_leaves(gf), tree_leaves(gd)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_unstacked_leaf_grad_is_the_sum_of_its_layers():
    """A stacked leaf unbound once: its grad is the sum over the layers of
    each slice's grad placed in its row (the stack of the per-layer
    grads), and equal to what indexing t[i] per layer gives; the layers'
    views share the stack's storage."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 4)).astype(np.float32))
    w0 = rng.standard_normal((3, 4, 5)).astype(np.float32)

    def run(per_layer):
        w = torch.as_tensor(w0).requires_grad_(True)
        c = torch.ones(3, 5, requires_grad=True)
        layers = per_layer({"w": w, "b": {"c": c}})
        h = x
        for lp in layers:
            h = torch.tanh(h @ lp["w"] + lp["b"]["c"])[:, :4]
        views = [lp["w"] for lp in layers]
        grads = torch.autograd.grad(h.square().sum(), [w, c] + views)
        return w, layers, grads

    w, layers, (gw, gc, *gviews) = run(unstack)
    assert len(layers) == 3
    assert all(layers[i]["w"].data_ptr() == w[i].data_ptr()
               for i in range(3))
    rows = torch.zeros_like(gw)
    for i, g in enumerate(gviews):
        rows[i] += g
    torch.testing.assert_close(gw, rows, rtol=0, atol=0)
    _, _, (hw, hc, *_) = run(
        lambda t: [tree_map(lambda a: a[i], t) for i in range(3)])
    torch.testing.assert_close(gw, hw, rtol=0, atol=0)
    torch.testing.assert_close(gc, hc, rtol=0, atol=0)
