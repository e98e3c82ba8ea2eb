"""The ten LM architectures on the port, held against `repro` on the CPU.

Twin of `tests/test_archs.py`. At each arch's SMOKE config the
reference's parameters (`repro.models.layers.materialize`) are carried to
the port by `params_from_numpy`; the loss, the prefill logits and 4
decode steps agree with the reference's at an f32 relative 2-norm <= 1e-5
and at the reference's own rtol 2e-3 / atol 2e-4, the MoE archs route
every token to the same experts and keep the same slots, and the port's
prefill + decode agree with its own full forward over the same tokens.
At the FULL configs the parameter counts and the input specs (meta
tensors: nothing allocated) equal the reference's.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.api import SHAPES as JSHAPES
from repro.models.api import Model as JModel
from repro.models.layers import materialize as jmaterialize
from repro.models.layers import param_count as jparam_count
from repro_torch.configs import registry
from repro_torch.lint import runtime as rt
from repro_torch.models import llava as lv
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wh
from repro_torch.models.api import SHAPES, Model
from repro_torch.models.layers import (decl_shapes, param_count,
                                       params_from_numpy, tree_leaves)

PROMPT, STEPS, BATCH = 16, 4, 2
REL = 1e-5                       # f32 relative 2-norm against the reference
RTOL, ATOL = 2e-3, 2e-4          # the reference's own cache tolerance


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert rel2(got, want) <= REL, (what, rel2(got, want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


class _Proxy:
    """A module whose named attributes are replaced."""

    def __init__(self, real, **over):
        self._real = real
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._real, name)


@contextlib.contextmanager
def reference_routes(monkeypatch):
    """Record the reference's expert choices and dispatch tensors, in call
    order: its `lax.top_k` and dispatch einsum, each followed by an
    ordered `jax.debug.callback` (values reach the host from inside the
    jitted layer scan)."""
    picks, slots = [], []

    def keep(log):
        return lambda v: log.append(np.asarray(v))

    def top_k(x, k):
        out = jax.lax.top_k(x, k)
        jax.debug.callback(keep(picks), out[1], ordered=True)
        return out

    def einsum(spec, *ops, **kw):
        if spec == "gsec,gsd->egcd":
            jax.debug.callback(keep(slots), ops[0], ordered=True)
        return jnp.einsum(spec, *ops, **kw)

    monkeypatch.setattr(jmoe, "jax", _Proxy(jax, lax=_Proxy(jax.lax,
                                                             top_k=top_k)))
    monkeypatch.setattr(jmoe, "jnp", _Proxy(jnp, einsum=einsum))
    yield picks, slots


@contextlib.contextmanager
def port_routes():
    """Record the port's (expert indices, dispatch tensor) of every MoE
    call in the block, in call order: its `top_k` and dispatch einsum,
    wrapped for the block."""
    routes, last = [], []
    real_top_k = moe.top_k

    def top_k(probs, k):
        out = real_top_k(probs, k)
        last[:] = [out[1]]
        return out

    def einsum(spec, *ops):
        if spec == "gsec,gsd->egcd":
            routes.append((last[0], ops[0]))
        return torch.einsum(spec, *ops)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "top_k", top_k)
        mp.setattr(moe, "torch", _Proxy(torch, einsum=einsum))
        yield routes


class _Jitted:
    """The reference's Model with loss, prefill and decode jitted (one
    compile each; decode's serves every step)."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.loss = jax.jit(model.loss)
        self.prefill = jax.jit(model.prefill, static_argnames="cache_len")
        self.decode = jax.jit(model.decode)


def make_batch(cfg, seed):
    """(numpy batch of PROMPT + STEPS tokens, frames / patches)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT + STEPS))
         .astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (BATCH, cfg.src_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    return b


def serve(model, params, batch, to, device=None):
    """Loss over the whole batch, prefill of PROMPT tokens into a cache of
    PROMPT + STEPS (+ n_patches), then STEPS decode steps. Returns numpy
    (loss, prefill logits, [step logits])."""
    cfg = model.cfg
    full = {k: to(v) for k, v in batch.items()}
    loss, _ = model.loss(params, full)
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    prompt = dict(full, tokens=full["tokens"][:, :PROMPT])
    kw = {} if device is None else {"device": device}
    logits, cache = model.prefill(params, prompt,
                                  cache_len=PROMPT + STEPS + extra, **kw)
    steps = []
    for i in range(PROMPT, PROMPT + STEPS):
        lg, cache = model.decode(params, {
            "tokens": full["tokens"][:, i:i + 1], "cache": cache})
        steps.append(np.asarray(lg))
    return float(loss), np.asarray(logits), steps


def full_forward(cfg, params, batch):
    """The port's logits over all PROMPT + STEPS tokens in one pass."""
    toks = torch.as_tensor(batch["tokens"])
    if cfg.family in ("dense", "moe"):
        return tf.lm_apply(cfg, params, toks)[0]
    if cfg.family == "ssm":
        return mb.mamba_lm_apply(cfg, params, toks)[0]
    if cfg.family == "hybrid":
        return mb.zamba_apply(cfg, params, toks)[0]
    if cfg.family == "encdec":
        enc = wh.encode(cfg, params, torch.as_tensor(batch["frames"]))
        return wh.decode_stack(cfg, params, toks, enc)[0]
    return lv.llava_apply(cfg, params, toks,
                          torch.as_tensor(batch["patches"]))[0]


@pytest.fixture(scope="module", params=ARCH_IDS)
def smoke(request):
    """Per arch at SMOKE: the reference's and the port's readings on the
    same parameters and tokens, with the MoE routes of both."""
    arch = request.param
    jcfg, cfg = jget_config(arch, smoke=True), registry.get_config(
        arch, smoke=True)
    jmodel, model = JModel(jcfg), Model(cfg)
    jparams = jmaterialize(jmodel.decls(), jax.random.key(3))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    batch = make_batch(cfg, 7)
    mp = pytest.MonkeyPatch()
    try:
        with reference_routes(mp) as (jpicks, jslots):
            want = serve(_Jitted(jmodel), jparams, batch, jnp.asarray)
            jax.effects_barrier()
    finally:
        mp.undo()
    with port_routes() as routes:
        got = serve(model, params, batch, torch.as_tensor, device="cpu")
    return dict(arch=arch, cfg=cfg, params=params, batch=batch, got=got,
                want=want, routes=routes, jpicks=jpicks, jslots=jslots)


def test_smoke_loss_matches_reference(smoke):
    close([smoke["got"][0]], [smoke["want"][0]], f"{smoke['arch']} loss")


def test_smoke_prefill_matches_reference(smoke):
    close(smoke["got"][1], smoke["want"][1], f"{smoke['arch']} prefill")


def test_smoke_decode_matches_reference(smoke):
    for i, (got, want) in enumerate(zip(smoke["got"][2], smoke["want"][2])):
        close(got, want, f"{smoke['arch']} decode step {i}")


def test_smoke_routes_match_reference(smoke):
    """Every MoE call (loss, prefill, each decode step, each layer) picks
    the reference's experts and keeps the same capacity slots."""
    if not smoke["cfg"].n_experts:
        assert not smoke["routes"] and not smoke["jpicks"]
        return
    routes = smoke["routes"]
    assert len(routes) == len(smoke["jpicks"]) == len(smoke["jslots"])
    assert len(routes) == smoke["cfg"].n_layers * (2 + STEPS)
    for (picks, slots), jpicks, jslots in zip(routes, smoke["jpicks"],
                                              smoke["jslots"]):
        np.testing.assert_array_equal(picks.numpy(), jpicks)
        np.testing.assert_array_equal(slots.numpy(), jslots)


def test_smoke_prefill_decode_match_own_full_forward(smoke):
    """The port's cache path against its own one-pass forward over the
    prompt and the decoded tokens (the reference's invariant,
    tests/test_models.py:59). The passes group MoE tokens differently, so
    the MoE archs run with a capacity that drops no token."""
    cfg = smoke["cfg"]
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = Model(cfg)
    with port_routes() as routes:
        _, pre, steps = serve(model, smoke["params"], smoke["batch"],
                              torch.as_tensor, device="cpu")
        full = full_forward(cfg, smoke["params"], smoke["batch"]).numpy()
    for _, slots in routes:        # every token kept its top_k slots
        assert float(slots.sum()) == cfg.top_k * slots.shape[0] * \
            slots.shape[1]
    np.testing.assert_allclose(np.concatenate([pre] + steps, axis=1), full,
                               rtol=RTOL, atol=ATOL)


def test_smoke_decode_reads_nothing_to_the_host(smoke):
    """Four decode steps under the CPU sync guard: no implicit pull."""
    cfg = smoke["cfg"]
    model = Model(cfg)
    batch = {k: torch.as_tensor(v) for k, v in smoke["batch"].items()}
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    _, cache = model.prefill(
        smoke["params"], dict(batch, tokens=batch["tokens"][:, :PROMPT]),
        cache_len=PROMPT + STEPS + extra, device="cpu")
    before = rt.sync_counts()
    with rt.no_implicit_syncs("cpu"):
        for i in range(PROMPT, PROMPT + STEPS):
            _, cache = model.decode(smoke["params"], {
                "tokens": batch["tokens"][:, i:i + 1], "cache": cache})
    assert rt.sync_counts() == before


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count(arch):
    n = param_count(Model(registry.get_config(arch)).decls())
    assert n == jparam_count(JModel(jget_config(arch)).decls())


def _specs(tree):
    return [(tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
            for t in tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_input_specs(arch):
    """Every supported (arch x shape) gives the reference's input specs,
    as meta tensors, and logical axes of the same structure."""
    model, jmodel = Model(registry.get_config(arch)), JModel(
        jget_config(arch))
    assert set(SHAPES) == set(JSHAPES)
    for name, shape in SHAPES.items():
        assert model.supports(shape) == jmodel.supports(JSHAPES[name])
        assert model.skip_reason(shape) == jmodel.skip_reason(JSHAPES[name])
        if not model.supports(shape):
            continue
        specs = model.input_specs(shape)
        assert all(t.is_meta for t in tree_leaves(specs))
        jspecs = jmodel.input_specs(JSHAPES[name])
        want = [(tuple(s.shape), s.dtype.name)
                for s in jax.tree.leaves(jspecs)]
        assert _specs(specs) == want, (arch, name)
        is_axes = (lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
        assert (tree_leaves(model.input_logical(shape), is_axes)
                == jax.tree.leaves(jmodel.input_logical(JSHAPES[name]),
                                   is_leaf=is_axes)), (arch, name)
    params = decl_shapes(model.decls())
    assert all(t.is_meta for t in tree_leaves(params))
