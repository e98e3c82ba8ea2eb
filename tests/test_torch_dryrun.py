"""The meta-device dry run (`repro_torch.launch.dryrun_bltc`) against the
reference's shape table, and the profiler transfer counts
(`repro_torch.obs.transfers`)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.api import TreecodeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun_bltc as dr
from repro_torch.obs.transfers import count_transfer_events, count_transfers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(theta=0.8, degree=8, leaf_size=4000, batch_size=4000)

# The reference module sets XLA_FLAGS to 512 host devices when imported,
# so its table is read in a subprocess of its own.
_REFERENCE = r"""
import json, sys
from repro.core.api import TreecodeConfig
from repro.launch.dryrun_bltc import synthetic_shapes
nranks, n = int(sys.argv[1]), int(sys.argv[2])
sds, meta = synthetic_shapes(nranks, n, TreecodeConfig(
    theta=0.8, degree=8, leaf_size=4000, batch_size=4000))
print(json.dumps({"shapes": {k: [list(v.shape), str(v.dtype)]
                             for k, v in sds.items()}, "meta": meta}))
"""


@pytest.mark.parametrize("nranks,n_per_rank", [(4, 20000), (256, 262144)])
def test_synthetic_shapes_match_the_reference(nranks, n_per_rank):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _REFERENCE, str(nranks),
                        str(n_per_rank)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    ref = json.loads(p.stdout.strip().splitlines()[-1])
    tables, meta = dr.synthetic_shapes(nranks, n_per_rank,
                                       TreecodeConfig(**CFG))
    assert meta == ref["meta"]
    ours = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in tables.items()}
    assert ours == ref["shapes"]
    assert all(v.is_meta for v in tables.values())


def test_meta_step_shape_and_report(monkeypatch):
    """The dry run calls the sharded plan's own executor, once for the
    potentials and once for the forces, on meta tensors."""
    from repro_torch.distributed import bltc
    spans = []
    sweep = bltc.sharded_sweep

    def counted(span, *args, **kw):
        spans.append(span)
        return sweep(span, *args, **kw)

    monkeypatch.setattr(bltc, "sharded_sweep", counted)
    res = dr.dry_run(4, 20000)
    assert spans == ["lane", "field"]
    assert res["status"] == "ok" and res["mesh"] == "4"
    assert res["phi_shape"] == [4 * 20000]
    assert res["forces"]["shape"] == [[4 * 20000], [4 * 20000, 3]]
    assert res["per_rank"]["peak_live_output_bytes"] > 0
    assert res["bytes_per_rank"] >= res["per_rank"]["argument_bytes"] \
        - res["per_rank"]["replicated_input_bytes"]
    # lo, hi and q_hat, then the potentials; two halo rounds of points,
    # charges and particle counts
    coll = res["collectives"]
    assert coll["all-gather"]["count"] == 4
    assert coll["collective-permute"]["count"] == 6
    assert dr.dry_run(4, 20000, multi=True)["mesh"] == "2x2"


def test_model_interactions_follow_the_reference_formula():
    cfg = TreecodeConfig(**CFG)
    tables, meta = dr.synthetic_shapes(256, 262144, cfg)
    nbatches = max(2, int(1.3 * 262144 / 4000))
    want = nbatches * 48 * 4000 * 9 ** 3 + nbatches * 32 * 4000 * 4000
    assert dr.model_interactions_per_rank(tables, cfg, meta["k3"]) == want
    res = dr.dry_run(8, 20000)
    t8, m8 = dr.synthetic_shapes(8, 20000, cfg)
    assert res["model_interactions_per_rank"] == \
        dr.model_interactions_per_rank(t8, cfg, m8["k3"])
    assert res["flops_per_rank"] == 12 * res["model_interactions_per_rank"]


def test_meta_branch_allocates_no_plain_intermediate():
    """The kernel entries' meta branch: the kernel's output shape, and
    nothing is computed (so no (B, NB, S, m) intermediate)."""
    from repro_torch.core.potentials import coulomb
    meta = torch.device("meta")
    idx = torch.empty((5, 7), dtype=torch.int32, device=meta)
    tgt = torch.empty((5, 100, 3), device=meta)
    pts = torch.empty((9, 729, 3), device=meta)
    q = torch.empty((9, 729), device=meta)
    tally = dr.ByteTally()
    with tally:
        out = ops.batch_cluster_eval(idx, tgt, pts, q, kernel=coulomb())
    assert out.shape == (5, 100) and out.is_meta
    assert tally.peak == out.nbytes
    assert ops.batch_cluster_field(idx, tgt, pts, q,
                                   kernel=coulomb()).shape == (5, 100, 4)
    with pytest.raises(ValueError):
        ops.batch_cluster_eval(idx, tgt, pts, q, kernel=coulomb(),
                               backend="cuda")


def test_planted_item_in_the_meta_path_raises(monkeypatch):
    """A host pull on the executor's path fails the dry run: .item() of a
    meta tensor raises."""
    orig = ops.modified_charges_ranged

    def pulls(src_sorted, q_sorted, *args, **kw):
        q_sorted.sum().item()
        return orig(src_sorted, q_sorted, *args, **kw)

    monkeypatch.setattr(ops, "modified_charges_ranged", pulls)
    with pytest.raises(RuntimeError):
        dr.dry_run(4, 20000)


def test_count_transfer_events_on_built_records():
    events = [
        {"name": "Memcpy DtoH (Device -> Pageable)", "cat": "gpu_memcpy",
         "args": {"bytes": 24}},
        {"name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy",
         "args": {"bytes": 4000}},
        {"name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy",
         "args": {"bytes": 8}},
        {"name": "Memcpy DtoD (Device -> Device)", "cat": "gpu_memcpy",
         "args": {"bytes": 64}},
        {"name": "cudaStreamSynchronize", "cat": "cuda_runtime"},
        {"name": "cudaMemcpyAsync", "cat": "cuda_runtime"},
        {"name": "bc_eval_kernel<float>", "cat": "kernel"},
        {"name": "aten::add", "cat": "cpu_op"},
    ]
    c = count_transfer_events(events)
    assert c["DtoH"] == {"count": 1, "bytes": 24}
    assert c["HtoD"] == {"count": 2, "bytes": 4008}
    assert c["DtoD"] == {"count": 1, "bytes": 64}
    assert c["syncs"] == {"cudaStreamSynchronize": 1,
                          "cudaDeviceSynchronize": 0,
                          "cudaEventSynchronize": 0}
    assert c["kernels"] == 1
    # a window keeps the host's runtime calls inside it, and every
    # device event
    timed = [dict(e, ts=t) for e, t in zip(events, (5, 6, 7, 8, 50, 51,
                                                    52, 53))]
    c = count_transfer_events(timed, window=(0.0, 10.0))
    assert c["syncs"]["cudaStreamSynchronize"] == 0
    assert c["DtoH"]["count"] == 1 and c["kernels"] == 1


def test_count_transfers_on_the_cpu_is_zero():
    if torch.cuda.is_available():
        pytest.skip("counts device activity where there is a card")
    out, c = count_transfers(lambda x: (x * 2).sum(), torch.ones(8))
    assert float(out) == 16.0
    assert all(c[k]["count"] == 0 for k in ("HtoD", "DtoH", "DtoD"))
    assert not any(c["syncs"].values()) and c["kernels"] == 0
