"""The LM skeleton in bf16 on the port, held against `repro` on the CPU.

The FULL configs run in bf16. The reference asks XLA for f32 results of
its bf16 einsums (`preferred_element_type`: the attention scores, the
chunked attention's products, the SSD's `cb`); the port casts the
operands to f32 at those points. Here the same bf16 inputs and the
reference's bf16 parameters (`params_from_numpy`) go through both:

- attention, dense and KV-chunked: bitwise the reference's. A port that
  kept the scores or a chunk's products in bf16 fails these cases.
- the SSD scan (chunked and recurrent), and two small archs (prefill and
  4 decode steps): elsewhere XLA fuses a chain of elementwise operations
  and rounds it once, so the two bf16 results differ by the rounding
  itself. The port's error against the reference's f32 result on the
  same (bf16-valued) inputs and parameters is held to at most
  `RATIO` times the reference's own bf16 error.
- the MoE layer: the same experts and kept slots as the reference, its
  output within two bf16 ulps (2^-7, relative 2-norm) of the
  reference's and its aux loss at f32 rounding.

On the CPU PyTorch's bf16 matmul sums in f32 inside the call, so the
f32 casts at the points above change one rounding of an output; the
attention cases show it, the scan's and the archs' bars cannot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import layers as jl
from repro.models import mamba2 as jmb
from repro.models import moe as jmoe
from repro.models.api import Model as JModel
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import registry
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe
from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig
from test_torch_archs import _Jitted, port_routes, reference_routes

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
RATIO = 2.0         # the port's bf16 error over the reference's, at most
PROMPT, STEPS = 16, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_pair(a):
    """(jax bf16 array, torch bf16 tensor) of the same 16-bit values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(np.asarray(j).view(np.uint16))).view(
        torch.bfloat16)


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def rel2(got, want) -> float:
    got, want = f64(got), f64(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def within_rounding(port, ref, exact, what):
    """The port's bf16 error against `exact` is at most RATIO times the
    reference's bf16 error against it."""
    mine, theirs = rel2(port, exact), rel2(ref, exact)
    assert 0 < theirs and mine <= RATIO * theirs, (what, mine, theirs)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_attention_is_the_references(chunked, causal):
    """GQA attention in bf16 with a kv_len mask (the chunked path over a
    ragged last chunk), scores of a few units: bitwise the reference's."""
    kw = dict(attn_dense_max=4, attn_chunk=8) if chunked else {}
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, remat=False, **BF16, **kw)
    cfg, jcfg = ModelConfig(**base), JConfig(**base)
    r = np.random.default_rng(2)
    b, s, t, d = 2, 16, 40, 32
    (jq, q), (jk, k), (jv, v) = (bf16_pair(r.standard_normal(shape)) for shape
                                 in ((b, s, 4, d), (b, t, 2, d), (b, t, 2, d)))
    q, jq = q * 4, jq * 4
    pos = np.broadcast_to(np.arange(s) + 24, (b, s)).astype(np.int32)
    kv_len = np.array([30, 40], np.int32)
    got = tl.attention(cfg, q, k, v, torch.as_tensor(pos),
                       kv_len=torch.as_tensor(kv_len), causal=causal)
    want = jl.attention(jcfg, jq, jk, jv, jnp.asarray(pos),
                        kv_len=jnp.asarray(kv_len), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f64(got), f64(want))


def _ssd_case(state):
    base = dict(name="s", family="ssm", d_model=64, ssm_state=state,
                ssm_head_dim=16, ssm_chunk=16, remat=False)
    cfg = ModelConfig(**base)
    r = np.random.default_rng(state)
    b, length, h = 2, 40, cfg.ssm_heads
    arrays = (r.standard_normal((b, length, h, 16)),
              r.standard_normal((b, length, state)),
              r.standard_normal((b, length, state)),
              r.uniform(0.01, 0.3, (b, length, h)),
              -np.exp(r.standard_normal(h) * 0.3))
    return cfg, JConfig(**base), [bf16_pair(a) for a in arrays]


@pytest.mark.parametrize("state", [16, 128])
def test_bf16_ssd_within_the_references_rounding(state):
    """The chunked scan and the recurrence in bf16 (state sizes of the
    SMOKE and the FULL mamba2): y and the final state."""
    cfg, jcfg, pairs = _ssd_case(state)
    jin = [j for j, _ in pairs]
    tin = [t for _, t in pairs]
    j32 = [j.astype(jnp.float32) for j in jin]
    for port, ref in ((mb.ssd_chunked, jmb.ssd_chunked),
                      (mb.ssd_recurrent, jmb.ssd_recurrent)):
        y, st = port(cfg, *tin)
        jy, jst = ref(jcfg, *jin)
        ey, est = ref(jcfg, *j32)
        assert y.dtype == st.dtype == torch.bfloat16
        within_rounding(y, jy, ey, f"{port.__name__} y")
        within_rounding(st, jst, est, f"{port.__name__} state")


@pytest.mark.parametrize("kw", [{}, dict(capacity_factor=0.5)])
def test_bf16_moe_matches_reference(kw):
    """The MoE layer in bf16 (capacity_factor 0.5 drops tokens): the
    reference's experts and kept slots, its output within 2^-7."""
    base = dict(name="m", family="moe", n_layers=1, d_model=64, d_ff=64,
                vocab=32, n_experts=8, top_k=2, moe_group=32, remat=False,
                **BF16, **kw)
    cfg, jcfg = ModelConfig(**base), JConfig(**base)
    jp = jl.materialize(jmoe.moe_init(jcfg), jax.random.key(0))
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jx, x = bf16_pair(np.random.default_rng(1).standard_normal((2, 16, 64)))
    with port_routes() as routes:
        y, aux = moe.moe_apply(cfg, params, x)
    with pytest.MonkeyPatch.context() as mp:
        with reference_routes(mp) as (jpicks, jslots):
            jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
            jax.effects_barrier()
    (picks, slots), = routes
    np.testing.assert_array_equal(picks.numpy(), jpicks[0])
    np.testing.assert_array_equal(f64(slots), f64(jslots[0]))
    assert y.dtype == torch.bfloat16
    assert rel2(y, jy) <= 2.0 ** -7, rel2(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _serve(model, params, batch, to, cache_len, device=None):
    """[prefill logits, 4 decode steps' logits] of PROMPT + STEPS tokens."""
    full = {k: to(v) for k, v in batch.items()}
    kw = {} if device is None else {"device": device}
    logits, cache = model.prefill(
        params, dict(full, tokens=full["tokens"][:, :PROMPT]),
        cache_len=cache_len, **kw)
    out = [logits]
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = model.decode(params, {
            "tokens": full["tokens"][:, i:i + 1], "cache": cache})
        out.append(logits)
    return [f64(o) for o in out]


@pytest.mark.parametrize("arch", ["gemma-7b", "zamba2-1.2b"])
def test_bf16_arch_within_the_references_rounding(arch):
    """A dense arch and the hybrid (SSD, its shared attention, the conv
    caches) at SMOKE in bf16: the prefill and 4 decode steps, all the
    logits together, against the reference's f32 run on the same
    bf16-valued parameters and tokens."""
    jcfg32 = jget_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg32, **BF16)
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **BF16)
    jmodel = JModel(jcfg)
    jp = jl.materialize(jmodel.decls(), jax.random.key(3))
    params = tl.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = {"tokens": np.random.default_rng(7).integers(
        0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)}
    n = PROMPT + STEPS
    got = _serve(Model(cfg), params, batch, torch.as_tensor, n, "cpu")
    want = [_serve(_Jitted(m), p, batch, jnp.asarray, n) for m, p in (
        (jmodel, jp), (JModel(jcfg32),
                       jax.tree.map(lambda a: a.astype(jnp.float32), jp)))]
    stack = [np.concatenate([o.reshape(-1) for o in outs])
             for outs in [got] + want]
    within_rounding(*stack, arch)


def test_bf16_ssd_keeps_the_decay_deep_in_a_chunk():
    """A whole 256-chunk in bf16 with dt ~ softplus(N(0, 1)), as the
    FULL mamba2's: the port keeps the decay's running sum in f32, so its
    last 32 positions err like the recurrence's (~4e-3 against f32);
    the reference's bf16 sum loses the decay there (> 0.1)."""
    base = dict(name="s", family="ssm", d_model=256, ssm_state=128,
                ssm_head_dim=64, ssm_chunk=256, remat=False)
    cfg, jcfg = ModelConfig(**base), JConfig(**base)
    r = np.random.default_rng(11)
    b, length, h = 1, 256, cfg.ssm_heads
    raw = r.standard_normal((b, length, h))
    pairs = [bf16_pair(a) for a in (
        r.standard_normal((b, length, h, 64)),
        r.standard_normal((b, length, 128)) / 8,
        r.standard_normal((b, length, 128)) / 8,
        np.log1p(np.exp(raw)), -np.ones(h))]
    exact, _ = jmb.ssd_chunked(jcfg, *(j.astype(jnp.float32)
                                       for j, _ in pairs))
    tail = slice(224, 256)
    got, _ = mb.ssd_chunked(cfg, *(t for _, t in pairs))
    rec, _ = mb.ssd_recurrent(cfg, *(t for _, t in pairs))
    ref, _ = jmb.ssd_chunked(jcfg, *(j for j, _ in pairs))
    want = f64(exact)[:, tail]
    mine, steps = rel2(got[:, tail], want), rel2(rec[:, tail], want)
    assert mine <= 1e-2 and mine <= RATIO * steps, (mine, steps)
    assert rel2(f64(ref)[:, tail], want) > 0.1
