#!/usr/bin/env python3
"""Run the LM dry run over every (arch x shape x mesh) cell and tabulate it.

    python3 tools/dryrun_matrix.py --out DIR [--jobs 4] [--timeout 600]

Runs `python -m repro_torch.launch.dryrun --arch A --shape S --mesh M
--out DIR/A_S_M.json` for the ten archs, the reference's four shapes and
both meshes, `--jobs` cells at a time (each in its own process: the
dry run starts its own fake process group), skipping a cell whose JSON
is already in DIR. A cell past `--timeout` seconds is recorded as such.
Then prints a markdown table: per cell the per-device peak (GiB),
whether it fits the H100 (`fits_hbm`), the roofline's dominant term and
`dry_run_s`, or the skip reason or failure. Needs no card.
"""
import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = ("chatglm3-6b", "internlm2-1.8b", "gemma-7b", "stablelm-12b",
         "zamba2-1.2b", "whisper-small", "mamba2-1.3b",
         "granite-moe-1b-a400m", "arctic-480b", "llava-next-mistral-7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")
TERM = {"compute_s": "compute", "memory_s": "memory",
        "collective_s": "collective"}


def run(out, arch, shape, mesh, timeout):
    path = os.path.join(out, f"{arch}_{shape}_{mesh}.json")
    if os.path.exists(path):
        return
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", path]
    env = dict(os.environ, PYTHONPATH=SRC)
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=timeout)
        if p.returncode != 0:
            with open(path, "w") as f:
                json.dump({"status": "failed",
                           "error": p.stderr.strip().splitlines()[-1]}, f)
    except subprocess.TimeoutExpired:
        with open(path, "w") as f:
            json.dump({"status": f"past {timeout} s"}, f)


def cell(r):
    if r["status"] == "ok":
        return (f"{r['per_device']['peak_hbm_est'] / 2**30:.2f} "
                f"{'yes' if r['fits_hbm'] else 'no'} "
                f"{TERM[r['roofline']['dominant']]} {r['dry_run_s']}")
    return r["status"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s, m) for m in MESHES for a in ARCHS for s in SHAPES]
    with cf.ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(lambda c: run(args.out, *c, args.timeout), cells))
    reports = {c: json.load(open(os.path.join(args.out, "_".join(c) +
                                              ".json"))) for c in cells}
    skipped = {r.get("reason") for r in reports.values()
               if r["status"] == "skipped"}
    print("| arch | " + " | ".join(f"{s} {m}" for s in SHAPES
                                    for m in ("16x16", "2x16x16")) + " |")
    print("| --- " * (1 + len(SHAPES) * len(MESHES)) + "|")
    for a in ARCHS:
        print(f"| {a} | " + " | ".join(cell(reports[a, s, m]) for s in SHAPES
                                       for m in MESHES) + " |")
    for reason in sorted(r for r in skipped if r):
        print(f"\nskipped: {reason}")


if __name__ == "__main__":
    main()
