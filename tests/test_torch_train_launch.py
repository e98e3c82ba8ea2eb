"""The training launcher (`python -m repro_torch.launch.train`) and, on the
card, phase 17a of `chip_smoke.py`.

On the CPU: `--smoke --device cpu` trains, checkpoints and resumes, and
a resumed run ends on the uninterrupted run's parameters bitwise (one
torch thread: a CPU GEMM's sums may depend on the threads); every
family's stub inputs are the reference's zeros (that test alone imports
JAX, inside it); without a card and without `--device cpu` the launcher
raises. The `cuda` tests run 17a (the train step on the card against
the CPU, per arch) and need a card; they import no JAX.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import train
from repro_torch.models.layers import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(capsys, *args):
    params = train.main(["--smoke", "--device", "cpu", "--seq", "16",
                         "--batch", "4"] + [str(a) for a in args])
    return params, capsys.readouterr().out


def test_launcher_resumes_bitwise(tmp_path, capsys):
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
    _, out = run(capsys, "--steps", 12, "--ckpt-every", 6, "--ckpt-dir", cut)
    assert "resumed" not in out and "step    0 loss" in out
    assert sorted(os.listdir(cut)) == ["step_12", "step_6"]
    resumed, out = run(capsys, "--steps", 21, "--ckpt-every", 7,
                       "--ckpt-dir", cut)
    assert "resumed from step 12" in out and "step   20 loss" in out
    assert "watchdog flags" in out
    once, out = run(capsys, "--steps", 21, "--ckpt-dir", whole)
    assert "resumed" not in out
    for a, b in zip(tree_leaves(resumed), tree_leaves(once)):
        assert torch.equal(a, b)
    # nothing past --steps: a finished run resumes to no step at all
    again, out = run(capsys, "--steps", 21, "--ckpt-dir", cut)
    assert "resumed from step 21" in out and "step " not in out.split(
        "resumed from step 21")[1]
    for a, b in zip(tree_leaves(again), tree_leaves(once)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-mistral-7b",
                                  "mamba2-1.3b", "granite-moe-1b-a400m"])
def test_launcher_trains_every_family(arch, tmp_path, capsys):
    _, out = run(capsys, "--arch", arch, "--steps", 2, "--ckpt-dir",
                 str(tmp_path))
    assert f"{get_config(arch, smoke=True).name}:" in out
    assert "step    0 loss" in out and os.listdir(tmp_path) == []


def test_stub_inputs_are_seeded_by_the_step():
    """The stubs no longer depend on the step (nor take it): they are the
    reference launcher's ``jnp.zeros((batch, ...), cfg.adtype)`` inputs,
    equal in shape, dtype and value."""
    import jax.numpy as jnp
    from repro.configs.registry import get_config as ref_config
    for arch, name in (("whisper-small", "frames"),
                       ("llava-next-mistral-7b", "patches")):
        cfg, ref = get_config(arch, smoke=True), ref_config(arch, smoke=True)
        a = train.stub_inputs(cfg, 2, "cpu")[name]
        want = (jnp.zeros((2, ref.src_seq, ref.d_model), ref.adtype)
                if name == "frames" else
                jnp.zeros((2, ref.n_patches, ref.vision_dim), ref.adtype))
        assert a.dtype == cfg.adtype and str(want.dtype) == str(
            a.dtype).replace("torch.", "")
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(want, np.float32))
    assert train.stub_inputs(get_config("gemma-7b", smoke=True), 2,
                             "cpu") == {}
    batch = train.device_batch(get_config("whisper-small", smoke=True), {
        "tokens": np.zeros((2, 5), np.int32)}, "cpu")
    assert set(batch) == {"tokens", "frames"}


def test_launcher_asks_for_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


def test_launcher_refuses_the_production_meshes(tmp_path):
    with pytest.raises(ValueError, match="needs 256 devices"):
        train.main(["--smoke", "--device", "cpu", "--mesh", "single",
                    "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """17a for one arch: loss and grads, three AdamW steps, grad_accum 4
    against 1 and remat on against off, card against CPU."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    worst = chip_smoke.phase_train_smoke(cuda_device, archs=[arch])
    assert worst["grads"] <= chip_smoke.TRAIN_REL
    assert worst["remat"] <= 1e-6
