"""Perf hillclimbs: the three chosen (arch × shape) pairs + ablations.

Counterpart of the JAX package's ``benchmarks/perf_iterations.py``: the
same pairs and variants, each a dry-run of the port (meta device, counted
per device; :mod:`.dryrun_all`).

Pairs:
  1. grok-1-314b × train_4k    — most collective-bound & largest model; the
     pair most representative of the paper's technique (compressed federated
     round).  Iterations: uplink compression OFF→ON, MoE dense→capacity,
     remat grouping.
  2. musicgen-large × decode_32k — worst memory fit (MHA cache).
     Iteration: int8 KV cache.
  3. mixtral-8x7b × train_4k   — collective-bound MoE+SWA.  Iterations:
     dense→capacity dispatch, compression ablation, remat grouping.

Each variant runs prod + unrolled R=1/R=2 (exact extrapolated costs).
Results → results/torch/perf/<pair>__<variant>[__unrollN].json
"""
from __future__ import annotations

import os

from . import dryrun_all

OUT = os.path.join(dryrun_all.ROOT, "results", "torch", "perf")

EXPERIMENTS = {
    # pair 1: grok train
    ("grok-1-314b", "train_4k"): {
        "baseline": [],                       # capacity MoE + compressed uplink
        "no_compress": ["--no-compress"],     # ablate the paper's technique
        "dense_moe": ["--moe-dispatch", "dense"],
        "remat8": ["--remat-group", "8"],
    },
    # pair 2: musicgen decode
    ("musicgen-large", "decode_32k"): {
        "baseline": [],
        "kv_int8": ["--kv-int8"],
    },
    # pair 3: mixtral train
    ("mixtral-8x7b", "train_4k"): {
        "baseline": [],
        "no_compress": ["--no-compress"],
        "dense_moe": ["--moe-dispatch", "dense"],
        "remat8": ["--remat-group", "8"],
    },
}


def run_one(arch, shape, extra, tag, timeout=3600):
    old = dryrun_all.OUT_DIR
    dryrun_all.OUT_DIR = OUT
    try:
        ok = dryrun_all.run_one(arch, shape, "single", extra=extra, tag=tag,
                                timeout=timeout)
    finally:
        dryrun_all.OUT_DIR = old
    return ok


def main():
    failures = []
    for (arch, shape), variants in EXPERIMENTS.items():
        for vname, extra in variants.items():
            # production run (memory fits-check) + R1/R2 unrolled (costs)
            if not run_one(arch, shape, extra, vname):
                failures.append((arch, shape, vname, "prod"))
            for r in (1, 2):
                if not run_one(arch, shape,
                               extra + ["--unroll", "--scan-repeats", str(r)],
                               f"{vname}__unroll{r}"):
                    failures.append((arch, shape, vname, f"unroll{r}"))
    print("failures:", failures or "none")
    return failures


if __name__ == "__main__":
    main()
