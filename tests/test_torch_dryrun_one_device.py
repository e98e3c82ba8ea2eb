"""The LM dry run on one device (plain meta tensors) against a real CPU
step of the same config under the same cost analysis: the matmul FLOPs
equal exactly. No JAX."""
import pytest
import torch

from repro_torch.configs.registry import get_config, optimizer_for
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.api import Model, ShapeSpec
from repro_torch.models.config import shard_ctx_for_mesh
from repro_torch.models.layers import materialize, tree_map
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.training.step import make_train_step

ARCHS = ("internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-1.3b")
SHAPES = {"train": ShapeSpec("train_64", 64, 4, "train"),
          "decode": ShapeSpec("decode_64", 64, 4, "decode")}
CELLS = [(a, k) for a in ARCHS for k in SHAPES]


def _real_step(arch, kind):
    """(fn, args) of the same step on real CPU tensors."""
    model = Model(get_config(arch, smoke=True))
    ctx = shard_ctx_for_mesh(MeshShape((1, 1), ("data", "model")))
    params = materialize(model.decls(), 0, device="cpu")
    specs = model.input_specs(SHAPES[kind])
    gen = torch.Generator().manual_seed(3)
    batch = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), specs)
    batch["tokens"] = torch.randint(0, model.cfg.vocab, specs["tokens"].shape,
                                    generator=gen, dtype=torch.int32)
    if kind == "train":
        opt = get_optimizer(optimizer_for(arch))
        return make_train_step(model, opt, ctx), (params, opt.init(params),
                                                  batch)
    return (lambda p, b: model.decode(p, b, ctx)), (params, batch)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_one_device_matmul_flops_equal_a_real_step(arch, kind):
    model = Model(get_config(arch, smoke=True))
    rep = dryrun.one_device_report(arch, model, SHAPES[kind])
    assert rep["chips"] == 1 and rep["collectives"] == {}
    fn, args = _real_step(arch, kind)
    real = analyze(fn, *args)
    assert rep["matmul_flops_per_device"] == real.matmul_flops > 0
