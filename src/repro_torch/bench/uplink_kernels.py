"""Time of the packed uplink's two kernels on the card, at their rows' shapes.

    PYTHONPATH=src python src/repro_torch/bench/uplink_kernels.py
    PYTHONPATH=src python src/repro_torch/bench/uplink_kernels.py \\
        --against OTHER/src [--turns 1]

``quant_pipeline`` on stablelm-1.6b's largest leaf with its agent axis
(2 x 24 x 5632 x 2048 bf16 msg and cache, L = 255: the fused packed
uplink), and ``unpack_bits`` at the Fed-LT path's 10,000 values and at
2**24, b = 4, each through its wrapper: ms per call by CUDA events over
``iters`` calls back to back (least of ``repeats``), and device µs per
call from a CUDA graph of the calls, the replay timed by events (least of
three), since the host's dispatch can take longer than a small kernel.
Inputs are drawn on the card from a seed.  Prints one JSON line with the
card's name and power limit.  It calls only ``ops.quant_pipeline``,
``ops.pack_bits`` and ``ops.unpack_bits``, so the same file times an
older checkout when ``PYTHONPATH`` points at that checkout's ``src``.

With ``--against``, each turn runs the order this, other, other, this,
each run a process of its own (each checkout builds its kernels once,
into its own ``build/``), and prints each process's line tagged with its
version.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

LEAF = (2, 24, 5632, 2048)          # stablelm-1.6b's MLP weights, two agents
UNPACK_N, UNPACK_BITS = (10_000, 2**24), 4


def events_ms(fn, repeats: int, iters: int) -> list:
    """ms per call of ``fn`` over ``iters`` calls back to back, each of
    ``repeats`` runs (after three warm-up calls)."""
    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return runs


def graph_us(fn, calls: int) -> float:
    """Device µs per call: ``calls`` calls captured in one CUDA graph (its
    outputs in the graph's own pool), the replay timed by events, least
    of three."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        runs.append(1e3 * start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return min(runs)


def time_kernels(repeats: int, iters: int, seed: int = 30) -> dict:
    from repro_torch.bench.attention import card
    from repro_torch.kernels import _build, ops
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"card": card()}
    z = (0.6 * torch.randn(LEAF, generator=gen, device="cuda")).to(torch.bfloat16)
    c = (0.004 * torch.randn(LEAF, generator=gen, device="cuda")).to(torch.bfloat16)
    call = lambda: ops.quant_pipeline(z, c, levels=255, vmin=-1.0, vmax=1.0)
    runs = events_ms(call, repeats, iters)
    out["quant_pipeline"] = {"shape": list(LEAF), "dtype": "bfloat16", "levels": 255,
                             "ms": min(runs), "runs_ms": runs,
                             "graph_us": graph_us(call, 4)}
    del z, c, call
    for n in UNPACK_N:
        vals = torch.randint(0, 2**UNPACK_BITS, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
        words = ops.pack_bits(vals, UNPACK_BITS)
        call = lambda: ops.unpack_bits(words, UNPACK_BITS, n)
        if not torch.equal(call().view(torch.int32), vals):
            raise RuntimeError(f"unpack_bits of {n} values is not what pack_bits packed")
        runs = events_ms(call, repeats, iters)
        out[f"unpack_bits_{n}"] = {"n": n, "bits": UNPACK_BITS, "ms": min(runs),
                                   "runs_ms": runs, "graph_us": graph_us(call, 20)}
    return out


def compare(other: Path, turns: int, repeats: int, iters: int) -> None:
    versions = {"this": Path(__file__).resolve().parents[2], "other": other.resolve()}
    for _ in range(turns):
        for name in ("this", "other", "other", "this"):
            env = dict(os.environ, PYTHONPATH=str(versions[name]))
            proc = subprocess.run([sys.executable, __file__, "--repeats", str(repeats),
                                   "--iters", str(iters)], env=env, capture_output=True,
                                  text=True, check=True)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(rec, version=name, src=str(versions[name]))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's src: time the two in turns")
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("uplink_kernels.py needs a CUDA device")
    if args.against is not None:
        compare(args.against, args.turns, args.repeats, args.iters)
        return 0
    print(json.dumps(time_kernels(args.repeats, args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
