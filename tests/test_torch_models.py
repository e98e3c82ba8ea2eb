"""The LM skeleton's layers on the port, held against `repro` on the CPU.

Twin of `tests/test_models.py`: the same inputs, made from a seed with
numpy, go through the reference's function and the port's, with the
reference's parameters carried by `params_from_numpy`. Norms, RoPE,
dense and chunked attention, the MLP activations, the SSD scan (chunked
against the reference and against the recurrence), the MoE layer (its
output, aux loss, experts and kept slots) and the fused cross-entropy
agree at f32 (rtol 1e-5 unless stated); the port's own invariants
(chunked attention equal to dense, prefill + decode equal to the full
forward, fused CE equal to dense CE, RoPE norm-preserving, shard_residual
a no-op on one device) hold as the reference's tests state them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import mamba2 as jmb
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from test_torch_archs import port_routes, reference_routes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cls=ModelConfig, **kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=64, remat=False)
    base.update(kw)
    return cls(**base)


def both(a):
    """(jax array, torch tensor) of one numpy array."""
    return jnp.asarray(a), torch.as_tensor(a)


def close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def carried(jparams):
    return tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")


# --------------------------------------------------------------------------
# against the reference, per layer
# --------------------------------------------------------------------------


def test_norms_match_reference():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    scale = r.uniform(0.5, 1.5, 24).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32)
    (jx, tx), (js, ts), (jb, tb) = both(x), both(scale), both(bias)
    close(tl.rms_norm(tx, ts), jl.rms_norm(jx, js), what="rms_norm")
    close(tl.layer_norm(tx, ts, tb), jl.layer_norm(jx, js, jb),
          what="layer_norm")


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.0])
def test_rope_matches_reference(fraction):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = r.integers(0, 4000, (2, 7)).astype(np.int32)
    (jx, tx), (jp, tp) = both(x), both(pos)
    close(tl.rope(tx, tp, 10000.0, fraction),
          jl.rope(jx, jp, 10000.0, fraction), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_reference(chunked, causal):
    """GQA attention with a kv_len mask; the chunked path over a ragged
    last chunk (padded positions 2**30)."""
    kw = dict(attn_dense_max=4, attn_chunk=8) if chunked else {}
    cfg, jcfg = _tiny(**kw), _tiny(JConfig, **kw)
    r = np.random.default_rng(2)
    b, s, t = 2, 6, 21
    q = r.standard_normal((b, s, 4, 8)).astype(np.float32)
    k = r.standard_normal((b, t, 2, 8)).astype(np.float32)
    v = r.standard_normal((b, t, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s) + 9, (b, s)).astype(np.int32)
    kv_len = np.array([15, 21], np.int32)
    args = [both(a) for a in (q, k, v, pos, kv_len)]
    got = tl.attention(cfg, *(t for _, t in args[:4]), kv_len=args[4][1],
                       causal=causal)
    want = jl.attention(jcfg, *(j for j, _ in args[:4]), kv_len=args[4][0],
                        causal=causal)
    close(got, want)


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "gelu"])
def test_mlp_matches_reference(act):
    jcfg, cfg = _tiny(JConfig, act=act), _tiny(act=act)
    jp = jl.materialize(jl.mlp_init(jcfg), jax.random.key(4))
    x = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(
        np.float32)
    jx, tx = both(x)
    close(tl.mlp_apply(cfg, carried(jp), tx), jl.mlp_apply(jcfg, jp, jx))


def _ssd_inputs(seed, length, cfg):
    r = np.random.default_rng(seed)
    B, H, P, N = 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return (r.standard_normal((B, length, H, P)).astype(np.float32),
            r.standard_normal((B, length, N)).astype(np.float32),
            r.standard_normal((B, length, N)).astype(np.float32),
            r.uniform(0.01, 0.3, (B, length, H)).astype(np.float32),
            -np.exp(r.standard_normal(H) * 0.3).astype(np.float32))


def _ssm_cfg(cls, chunk):
    return cls(name="s", family="ssm", d_model=32, ssm_state=8,
               ssm_head_dim=8, ssm_chunk=chunk, remat=False)


@pytest.mark.parametrize("seed,chunk,length", [(0, 4, 5), (1, 8, 37),
                                               (2, 16, 40), (3, 16, 16)])
def test_ssd_chunked_matches_reference_and_recurrence(seed, chunk, length):
    """The chunked scan against the reference's (rtol 1e-5) and against
    its own recurrence (the reference's duality test, rtol 2e-4), from a
    zero and from a given state."""
    cfg, jcfg = _ssm_cfg(ModelConfig, chunk), _ssm_cfg(JConfig, chunk)
    arrays = _ssd_inputs(seed, length, cfg)
    pairs = [both(a) for a in arrays]
    init = np.random.default_rng(seed + 9).standard_normal(
        (2, 1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)).astype(
            np.float32)
    for state in (None, both(init)):
        kw_t = {} if state is None else {"init_state": state[1]}
        kw_j = {} if state is None else {"init_state": state[0]}
        y, s = mb.ssd_chunked(cfg, *(t for _, t in pairs), **kw_t)
        jy, js = jmb.ssd_chunked(jcfg, *(j for j, _ in pairs), **kw_j)
        close(y, jy, atol=1e-5, what="y")
        close(s, js, atol=1e-5, what="state")
        ry, rs = mb.ssd_recurrent(cfg, *(t for _, t in pairs), **kw_t)
        jry, jrs = jmb.ssd_recurrent(jcfg, *(j for j, _ in pairs), **kw_j)
        close(ry, jry, atol=1e-5, what="recurrent y")
        close(rs, jrs, atol=1e-5, what="recurrent state")
        close(y, ry, rtol=2e-4, atol=2e-5, what="chunked == recurrent")
        close(s, rs, rtol=2e-4, atol=2e-5, what="chunked == recurrent")


def test_ssd_chunked_masks_before_the_exp():
    """Large decays: exp of the (positive) entries above the diagonal
    would overflow to inf; masked to -inf first, every output stays
    finite and equal to the recurrence."""
    cfg = _ssm_cfg(ModelConfig, 16)
    x, bm, c, dt, ah = (torch.as_tensor(a) for a in _ssd_inputs(5, 32, cfg))
    ah = ah * 400.0
    y, s = mb.ssd_chunked(cfg, x, bm, c, dt, ah)
    ry, rs = mb.ssd_recurrent(cfg, x, bm, c, dt, ah)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    close(y, ry, rtol=2e-4, atol=2e-5)
    close(s, rs, rtol=2e-4, atol=2e-5)


def _moe_cfg(cls, **kw):
    base = dict(name="m", family="moe", n_layers=1, d_model=16, d_ff=32,
                vocab=32, n_experts=4, top_k=2, moe_group=32, remat=False)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("kw", [{}, dict(capacity_factor=0.5),
                                dict(act="gelu", n_experts=8, top_k=3)])
def test_moe_matches_reference(kw):
    """Output and aux loss, the experts picked and the capacity slots kept
    (capacity_factor 0.5 drops tokens), against the reference's; a router
    of equal columns makes every token a tie, which both break towards
    the lower expert index."""
    jcfg, cfg = _moe_cfg(JConfig, **kw), _moe_cfg(ModelConfig, **kw)
    jp = jl.materialize(jmoe.moe_init(jcfg), jax.random.key(0))
    x = np.random.default_rng(1).standard_normal((2, 16, 16)).astype(
        np.float32)
    jx, tx = both(x)
    for tie in (False, True):
        if tie:
            jp = dict(jp, router=jnp.broadcast_to(jp["router"][:, :1],
                                                  jp["router"].shape))
        with port_routes() as routes:
            y, aux = moe.moe_apply(cfg, carried(jp), tx)
        with pytest.MonkeyPatch.context() as mp:
            with reference_routes(mp) as (jpicks, jslots):
                jy, jaux = jmoe.moe_apply(jcfg, jp, jx)
                jax.effects_barrier()
        close(y, jy, what="y")
        close(aux, jaux, what="aux")
        (picks, slots), = routes
        np.testing.assert_array_equal(picks.numpy(), jpicks[0])
        np.testing.assert_array_equal(slots.numpy(), jslots[0])
        if tie:
            assert (picks.numpy() == np.arange(cfg.top_k)).all()
        kept = float(slots.sum())
        if tie or "capacity_factor" in kw:      # some tokens overflow
            assert kept < cfg.top_k * 32
        else:
            assert kept == cfg.top_k * 32


def test_cross_entropy_matches_reference():
    r = np.random.default_rng(3)
    logits = r.standard_normal((2, 9, 40)).astype(np.float32) * 4
    labels = r.integers(-1, 40, (2, 9)).astype(np.int32)
    (jlg, tlg), (jlb, tlb) = both(logits), both(labels)
    close(tl.cross_entropy(tlg, tlb), jl.cross_entropy(jlg, jlb))


# --------------------------------------------------------------------------
# the port's own invariants (tests/test_models.py)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_params():
    cfg = _tiny()
    return cfg, tl.materialize(tf.lm_decls(cfg), 0, device="cpu")


def _tokens(seed, shape, vocab):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32))


def test_chunked_attention_equals_dense(tiny_params):
    cfg, params = tiny_params
    cfg_c = dataclasses.replace(cfg, attn_dense_max=8, attn_chunk=8)
    tokens = _tokens(1, (2, 37), cfg.vocab)
    l1, _, _ = tf.lm_apply(cfg_c, params, tokens)
    l2, _, _ = tf.lm_apply(cfg, params, tokens)
    close(l1, l2, rtol=2e-4, atol=2e-4)


def test_prefill_decode_matches_full_forward():
    cfg = _tiny(qkv_bias=True, rope="half")
    params = tl.materialize(tf.lm_decls(cfg), 0, device="cpu")
    tokens = _tokens(1, (2, 20), cfg.vocab)
    full, _, _ = tf.lm_apply(cfg, params, tokens)
    pre, cache = tf.lm_prefill(cfg, params, tokens[:, :12], cache_len=20)
    close(pre, full[:, :12], rtol=2e-3, atol=2e-4)
    outs = []
    for i in range(12, 20):
        lg, new = tf.lm_decode(cfg, params, tokens[:, i:i + 1], cache)
        assert new["k"].data_ptr() == cache["k"].data_ptr()  # in place
        cache = new
        outs.append(lg)
    assert int(cache["pos"]) == 20
    close(torch.cat(outs, 1), full[:, 12:], rtol=2e-3, atol=2e-4)


def test_fused_ce_equals_dense_ce(tiny_params):
    cfg, params = tiny_params
    cfg_f = dataclasses.replace(cfg, ce_chunk=8)
    batch = {"tokens": _tokens(1, (4, 33), cfg.vocab)}
    l1, _ = tf.lm_loss(cfg, params, batch)
    l2, _ = tf.lm_loss(cfg_f, params, batch)
    assert float(torch.abs(l1 - l2)) < 1e-5


def test_fused_ce_matches_reference():
    jcfg, cfg = _tiny(JConfig, ce_chunk=8), _tiny(ce_chunk=8)
    jp = jl.materialize(jtf.lm_decls(jcfg), jax.random.key(0))
    toks = np.random.default_rng(2).integers(0, 64, (4, 33)).astype(np.int32)
    jt, tt = both(toks)
    got, _ = tf.lm_loss(cfg, carried(jp), {"tokens": tt})
    want, _ = jtf.lm_loss(jcfg, jp, {"tokens": jt})
    close(got, want)


def test_shard_residual_unsharded_noop(tiny_params):
    cfg, params = tiny_params
    cfg_s = dataclasses.replace(cfg, shard_residual=True)
    tokens = _tokens(1, (2, 9), cfg.vocab)
    l1, _, _ = tf.lm_apply(cfg, params, tokens)
    l2, _, _ = tf.lm_apply(cfg_s, params, tokens)
    assert torch.equal(l1, l2)


def test_moe_router_capacity_invariants():
    cfg = _moe_cfg(ModelConfig)
    params = tl.materialize(moe.moe_init(cfg), 0, device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 16, 16)).astype(np.float32))
    y, aux = moe.moe_apply(cfg, params, x)
    assert y.shape == x.shape
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    assert 0.0 < float(aux) < cfg.n_experts


@pytest.mark.parametrize("seed", range(4))
def test_rope_preserves_norm(seed):
    r = np.random.default_rng(seed)
    x = torch.as_tensor(r.standard_normal((2, 5, 3, 16)).astype(np.float32))
    pos = torch.as_tensor(r.integers(0, 1000, (2, 5)))
    y = tl.rope(x, pos, 10000.0, 1.0)
    close(torch.linalg.norm(y, dim=-1), torch.linalg.norm(x, dim=-1),
          rtol=1e-5, atol=0)
    # relative-position property: equal shifts leave q.k invariant
    y0 = tl.rope(x, pos * 0, 10000.0, 1.0)
    y7 = tl.rope(x, pos * 0 + 7, 10000.0, 1.0)
    close(torch.einsum("bshd,bshd->bsh", y0, y0),
          torch.einsum("bshd,bshd->bsh", y7, y7), rtol=1e-4, atol=0)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def test_params_from_numpy_takes_bfloat16_leaves():
    """A bf16 leaf arrives as numpy dtype 'bfloat16' (ml_dtypes); the port
    takes its 16-bit patterns: bitwise the reference's values."""
    x = jax.random.normal(jax.random.key(0), (3, 5), jnp.float32)
    tree = {"w": np.asarray(x.astype(jnp.bfloat16)),
            "nested": {"b": np.asarray(x), "i": np.arange(4, dtype=np.int32)}}
    assert tree["w"].dtype.name == "bfloat16"
    got = tl.params_from_numpy(tree, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].to(torch.float32).numpy(),
                                  np.asarray(x.astype(jnp.bfloat16)
                                             .astype(jnp.float32)))
    assert got["nested"]["b"].dtype == torch.float32
    assert torch.equal(got["nested"]["i"], torch.arange(4, dtype=torch.int32))


def test_materialize_is_deterministic_per_leaf():
    cfg = _tiny()
    decls = tf.lm_decls(cfg)
    a = tl.materialize(decls, 5, device="cpu")
    b = tl.materialize(decls, 5, device="cpu")
    c = tl.materialize(decls, 6, device="cpu")
    for x, y, z, d in zip(tl.tree_leaves(a), tl.tree_leaves(b),
                          tl.tree_leaves(c),
                          tl.tree_leaves(decls)):
        assert torch.equal(x, y)
        assert tuple(x.shape) == d.shape and str(x.dtype).endswith(d.dtype)
        if d.kind == "normal":
            assert not torch.equal(x, z)
    assert tl.param_count(decls) == jl.param_count(
        jtf.lm_decls(_tiny(JConfig)))


def test_entry_points_ask_for_a_device():
    """Without CUDA, materialize and prefill refuse the default device
    and run where device="cpu" asks."""
    if torch.cuda.is_available():
        pytest.skip("the CPU refusal shows only without a CUDA device")
    from repro_torch.models.api import Model
    cfg = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.materialize(tf.lm_decls(cfg), 0)
    params = tl.materialize(tf.lm_decls(cfg), 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).prefill(params, {"tokens": _tokens(0, (1, 4), 64)})


def test_prefill_refuses_inputs_off_its_device():
    """Prefill runs on its device only: tokens or parameters that lie
    elsewhere (here on the meta device) raise, and nothing runs."""
    from repro_torch.models.api import Model
    cfg = _tiny()
    model = Model(cfg)
    params = tl.materialize(tf.lm_decls(cfg), 0, device="cpu")
    tokens = _tokens(0, (1, 4), 64)
    with pytest.raises(ValueError, match="batch holds a tensor on meta"):
        model.prefill(params, {"tokens": tokens.to("meta")}, device="cpu")
    on_meta = tl.tree_map(lambda t: t.to("meta"), params)
    with pytest.raises(ValueError, match="params holds a tensor on meta"):
        model.prefill(on_meta, {"tokens": tokens}, device="cpu")
    logits, cache = model.prefill(params, {"tokens": tokens}, device="cpu")
    assert logits.device.type == cache["k"].device.type == "cpu"
