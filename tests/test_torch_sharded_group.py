"""`GroupRanks`: one rank per process over a 1-D `torch.distributed`
device mesh on gloo, against `StackedRanks` (every rank on one device)
on the same plan.

A subprocess (with its own timeout) spawns P processes with
`torch.multiprocessing`; each joins a gloo process group on localhost,
builds the plan with ``mesh=`` (the same host build everywhere, keeping
its own rank's row of every stacked array), runs execute and
potential_and_forces, and holds them at f64 rtol 1e-12 to the stacked
plan (``nranks=P``) it also builds; each of its arrays is its rank's row
of the stacked plan's."""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GROUP = r"""
import socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, p, port, errors):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=p, rank=rank)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.core.api import TreecodeConfig, TreecodeSolver
        from repro_torch.core.space import PeriodicBox
        from repro_torch.distributed.exchange import GroupRanks
        r = np.random.default_rng(p)
        x = r.uniform(0, 2, (1400, 3))
        q = r.uniform(-1, 1, 1400)
        cfg = TreecodeConfig(theta=0.8, degree=2, leaf_size=16,
                             space=PeriodicBox(2.0) if p == 4 else None,
                             skin=0.02, kernel="yukawa",
                             kernel_params={"kappa": 1.0})
        solver = TreecodeSolver(cfg, device="cpu")
        mesh = init_device_mesh("cpu", (p,))
        plan = solver.plan(x, mesh=mesh)
        assert isinstance(plan.ranks, GroupRanks)
        assert plan.arrays["tgt_batched"].shape[0] == 1
        # with a process group and no mesh or nranks, P is the world size
        assert solver.plan(x).nranks == p
        stacked = solver.plan(x, nranks=p)
        for k, v in plan.arrays.items():
            assert torch.equal(v[0], stacked.arrays[k][rank]), k
        assert stacked.stats()["halo_rounds_active"] >= 2
        phi, (fphi, F) = plan.execute(q), plan.potential_and_forces(q)
        sphi, (sfphi, sF) = stacked.execute(q), stacked.potential_and_forces(q)
        for got, want in ((phi, sphi), (fphi, sfphi), (F, sF)):
            torch.testing.assert_close(got, want, rtol=1e-12,
                                       atol=1e-12 * want.abs().max())
        # kernel parameter values per call, on every rank
        torch.testing.assert_close(
            plan.execute(q, kernel_params={"kappa": 0.5}),
            stacked.execute(q, kernel_params={"kappa": 0.5}),
            rtol=1e-12, atol=0.0)
    except Exception as e:  # reported by the parent
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


@pytest.mark.parametrize("p", [2, 4])
def test_group_ranks_match_stacked_ranks(p, tmp_path):
    script = tmp_path / "group.py"
    script.write_text(textwrap.dedent(_GROUP))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(p)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert proc.stdout.strip().endswith("ok")
