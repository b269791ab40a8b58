"""Time of flash_attention's forward on the card, at a path's shape.

    PYTHONPATH=src python src/repro_torch/bench/attention.py [--dtype bfloat16]
        [--repeats 10]
    PYTHONPATH=src python src/repro_torch/bench/attention.py \\
        --against OTHER/src [--dtype float32] [--turns 5] [--repeats 10]

bf16 (the default) times the route of h2o-danube-3-4b's prefill
attention: B=4, S=8192, H=32, Hkv=8, D=120, causal, window 4096.
float32 times the float32 route at the depth-2 float32 prefill's shape
(``chip_smoke.py``'s serving check): B=1, S=5000, the same heads and
window.  q, k and v are drawn on the card from a seed in the dtype; three
calls warm up, then ``repeats`` runs each time ``iters`` calls back to
back with CUDA events (ms per call: the wrapper's host time hides behind
the kernels, as in a prefill).  Prints one JSON
line: the least and the median ms, every run, the launches of one call
and the card's name and power limit.  It calls only ``flash_attention``,
which every version of the port has, so the same file times an older
checkout when ``PYTHONPATH`` points at that checkout's ``src``.

With ``--against``, it compares this checkout's ``src`` with another
instead: ``turns`` times the order this, other, other, this, each run a
process of its own (each checkout builds its kernels once, into its own
``build/``), so that neither version always runs first.  Prints each
process's JSON line, then one line with each version's median of the
processes' medians, the median of all its runs and its least run, and
how many of the 2·turns adjacent pairs (this, other) and (other, this)
each version won by its process's median.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"bfloat16": dict(b=4, s=8192, h=32, hkv=8, d=120, window=4096),
          "float32": dict(b=1, s=5000, h=32, hkv=8, d=120, window=4096)}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def time_forward(dtype: str, repeats: int, iters: int, seed: int = 0) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    t = SHAPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((t["b"], t["s"], t["h"], t["d"]), generator=gen, device="cuda")
    k, v = (torch.randn((t["b"], t["s"], t["hkv"], t["d"]), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    call = lambda: flash_attention(q, k, v, window=t["window"])
    for _ in range(3):
        out = call()
    ops.reset_launch_counts()
    call()
    launches = {n: c for n, c in ops.launch_counts().items() if c}
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            out = call()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("flash_attention's output is not finite")
    return {"shape": t, "dtype": dtype, "iters": iters, "ms": min(runs),
            "median_ms": statistics.median(runs), "runs_ms": runs, "launches": launches,
            "card": card()}


def compare(other: Path, dtype: str, turns: int, repeats: int, iters: int) -> dict:
    here = Path(__file__).resolve().parents[2]
    versions = {"this": here, "other": other.resolve()}
    runs = {name: [] for name in versions}
    wins = {name: 0 for name in versions}
    order = ("this", "other", "other", "this")
    for _ in range(turns):
        medians = []
        for name in order:
            env = dict(os.environ, PYTHONPATH=str(versions[name]))
            proc = subprocess.run([sys.executable, __file__, "--dtype", dtype,
                                   "--repeats", str(repeats), "--iters", str(iters)],
                                  env=env, capture_output=True, text=True, check=True)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec.update(version=name, src=str(versions[name]))
            print(json.dumps(rec), flush=True)
            runs[name].append(rec)
            medians.append(rec["median_ms"])
        for i in (0, 2):                 # ties count for neither
            if medians[i] != medians[i + 1]:
                wins[order[i] if medians[i] < medians[i + 1] else order[i + 1]] += 1
    return {name: {"src": str(versions[name]),
                   "median_of_medians_ms": statistics.median(r["median_ms"] for r in recs),
                   "median_ms": statistics.median(x for r in recs for x in r["runs_ms"]),
                   "least_ms": min(r["ms"] for r in recs), "processes": len(recs),
                   "pairs_won": wins[name]}
            for name, recs in runs.items()} | {"dtype": dtype, "pairs": 2 * turns,
                                               "card": card()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(SHAPES), default="bfloat16",
                    help="the route and its path's shape")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's src: compare the two in turns")
    ap.add_argument("--turns", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention.py needs a CUDA device")
    if args.against is not None:
        print(json.dumps(compare(args.against, args.dtype, args.turns, args.repeats,
                                 args.iters)))
        return 0
    print(json.dumps(time_forward(args.dtype, args.repeats, args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
