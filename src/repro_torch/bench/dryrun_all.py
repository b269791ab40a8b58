"""Driver: baseline dry-runs for every (arch × shape × mesh) combination.

Counterpart of the JAX package's ``benchmarks/dryrun_all.py``.  Per
single-pod combo, three subprocess runs of ``python -m
repro_torch.launch.dryrun``:
  1. the production run    → per-device counts, memory fits-check
  2. unrolled, scan_repeats=1 ┐ exact per-unit costs; linear extrapolation
  3. unrolled, scan_repeats=2 ┘ total = c1 + (R−1)·(c2−c1)
Per multi-pod combo: the production run only (proves the pod axis shards).

Each run is a process of its own: it makes, and destroys, its fake process
group of 256 (512) ranks.  Runs on the host (meta tensors), no card.

Usage:  PYTHONPATH=src python -m repro_torch.bench.dryrun_all [--only arch] [--shapes ...]
Writes results/torch/dryrun/<arch>__<shape>__<mesh>[__variant].json
"""
from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time

ARCHS = ["musicgen-large", "granite-20b", "qwen2-vl-7b", "grok-1-314b",
         "mixtral-8x7b", "stablelm-1.6b", "gemma3-27b", "zamba2-2.7b",
         "h2o-danube-3-4b", "rwkv6-3b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
OUT_DIR = os.path.join(ROOT, "results", "torch", "dryrun")


def run_one(arch, shape, mesh, extra=(), tag="", timeout=3600):
    os.makedirs(OUT_DIR, exist_ok=True)
    name = f"{arch}__{shape}__{mesh}{('__' + tag) if tag else ''}"
    out = os.path.join(OUT_DIR, name + ".json")
    if os.path.exists(out):
        print(f"[skip done] {name}")
        return True
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out, *extra]
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                           env={**os.environ, "PYTHONPATH": "src"}, cwd=ROOT)
    except subprocess.TimeoutExpired:
        print(f"[TIMEOUT {timeout}s] {name}")
        return False
    ok = r.returncode == 0
    print(f"[{'ok' if ok else 'FAIL'} {time.time()-t0:6.0f}s] {name}")
    if not ok:
        err_path = out.replace(".json", ".err")
        with open(err_path, "w") as f:
            f.write(r.stdout[-5000:] + "\n---\n" + r.stderr[-10000:])
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-list of archs")
    ap.add_argument("--shapes", default=None, help="comma-list of shapes")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--skip-unroll", action="store_true")
    args = ap.parse_args(argv)

    archs = args.only.split(",") if args.only else ARCHS
    shapes = args.shapes.split(",") if args.shapes else SHAPES
    meshes = args.meshes.split(",")

    failures = []
    for arch, shape in itertools.product(archs, shapes):
        for mesh in meshes:
            if not run_one(arch, shape, mesh):
                failures.append((arch, shape, mesh, "prod"))
        if "single" in meshes and not args.skip_unroll:
            for r in (1, 2):
                if not run_one(arch, shape, "single",
                               ["--unroll", "--scan-repeats", str(r)],
                               tag=f"unroll{r}"):
                    failures.append((arch, shape, "single", f"unroll{r}"))
    print("\nFailures:", failures if failures else "none")
    return failures


if __name__ == "__main__":
    main()
