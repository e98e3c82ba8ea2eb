"""The port's op-level cost analysis (`repro_torch.launch.hlo_analysis`)
against the reference's HLO analyzer on the same programs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as ref
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import OpCounter, Totals, analyze


def _ref(f, *args):
    return ref.analyze(jax.jit(f).lower(*args).compile().as_text())


def test_python_loop_of_matmuls_counts_exactly():
    """L matmuls in a Python loop: 2 L M D^2 exactly, the dots of the
    reference's count of the same chain as a scan (which adds its loop
    counter's scalar ops)."""
    L, M, D = 8, 64, 256
    rng = np.random.default_rng(0)
    w = rng.standard_normal((L, D, D)).astype(np.float32)
    x = rng.standard_normal((M, D)).astype(np.float32)

    def port(ws, x):
        for w_ in ws:
            x = x @ w_
        return x

    t = analyze(port, torch.from_numpy(w).unbind(0), torch.from_numpy(x))
    want = 2 * L * M * D * D
    assert t.matmul_flops == want and t.flops == want

    def scanned(ws, x):
        return jax.lax.scan(lambda c, w_: (c @ w_, None), x, ws)[0]

    r = _ref(scanned, jnp.asarray(w), jnp.asarray(x))
    assert want <= r.flops <= want + 8 * L, (r.flops, want)


def test_single_dot_counts_as_the_reference():
    a, b = np.zeros((64, 128), np.float32), np.zeros((128, 32), np.float32)
    t = analyze(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    r = _ref(lambda x, y: x @ y, a, b)
    assert t.flops == 2 * 64 * 128 * 32 == r.flops
    assert t.hbm_bytes == a.nbytes + b.nbytes + 64 * 32 * 4


@pytest.mark.parametrize("op,per", [("add", 1), ("exp", 4)])
def test_elementwise_flops_per_element(op, per):
    n = 1024
    x = np.ones((n,), np.float32)
    if op == "add":
        t = analyze(torch.add, torch.from_numpy(x), torch.from_numpy(x))
        r = _ref(lambda a, b: a + b, x, x)
    else:
        t = analyze(torch.exp, torch.from_numpy(x))
        r = _ref(jnp.exp, x)
    assert t.flops == per * n == r.flops
    assert t.matmul_flops == 0


def test_all_reduces_on_a_fake_group_count_their_wire_bytes():
    """L all-reduces of S bytes on a group of g = 4: L of them, L 2S(g-1)/g
    bytes (the reference's ring model)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    L, g = 5, 4
    x = torch.empty((256, 8), dtype=torch.float32, device="meta")
    with dryrun.fake_group(g):
        group = dist.group.WORLD

        def step(x):
            for _ in range(L):
                x = funcol.all_reduce(x, "sum", group)
            return x

        t = analyze(step, x)
    assert not dist.is_initialized()
    S = x.nbytes
    assert t.collectives["all-reduce"]["count"] == L
    assert t.collectives["all-reduce"]["bytes"] == L * 2 * S * (g - 1) / g
    assert t.collective_bytes == L * 2 * S * (g - 1) / g


def test_stacked_index_copy_counts_at_window_size():
    """Writing L rows of an (L, D) buffer one at a time in place: about L
    windows, not L full buffers (quadratic in L)."""
    L, D = 64, 4096
    buf = torch.zeros((L, D))
    rows = torch.ones((L, 1, D))

    def fill(buf):
        for i in range(L):
            buf.index_copy_(0, torch.full((1,), i), rows[i] * 2.0)
        return buf

    t = analyze(fill, buf)
    full_quadratic = L * L * D * 4
    assert t.hbm_bytes < full_quadratic / 4, t.hbm_bytes


def _mlp_step(w1, w2, x):
    w1 = w1.detach().requires_grad_(True)
    w2 = w2.detach().requires_grad_(True)
    h = torch.tanh(x @ w1)
    loss = (h @ w2).square().mean()
    return torch.autograd.grad(loss, (w1, w2))


def test_meta_and_cpu_inputs_give_the_same_totals():
    rng = np.random.default_rng(1)
    shapes = [(32, 48), (48, 16), (8, 32)]
    cpu = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in shapes]
    meta = [torch.empty(s, device="meta") for s in shapes]
    a, b = analyze(_mlp_step, *cpu), analyze(_mlp_step, *meta)
    assert isinstance(a, Totals) and a.ops > 0
    assert a == b
    assert a.matmul_flops == 2 * (8 * 32 * 48 + 8 * 48 * 16) * 3 - \
        2 * 8 * 32 * 48     # no grad of x: the first layer's dx is skipped


def test_peak_follows_live_outputs():
    """The peak counts outputs that are alive together; a freed temporary
    does not add to a later one's."""
    x = torch.empty((1024,), device="meta")

    def chain(x):
        for _ in range(4):
            x = x + 1.0            # each result frees the one before
        return x

    with OpCounter() as c:
        out = chain(x)
    assert c.totals.peak_bytes == 2 * x.nbytes
    assert out.shape == x.shape
