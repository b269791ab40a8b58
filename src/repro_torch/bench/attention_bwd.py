"""The bf16 attention backward on the card: time and drift by group size.

    PYTHONPATH=src python src/repro_torch/bench/attention_bwd.py [--repeats 3]
    PYTHONPATH=src python src/repro_torch/bench/attention_bwd.py \\
        --against OTHER/src [--turns 1] [--repeats 3]

For each shape of SHAPES (B 2, causal; the training path's heads of
stablelm-1.6b, gemma3-27b, qwen2-vl-7b and granite-20b at S 2048, and a
sweep of query heads per KV head), q, k, v and dO are drawn on the card
from a seed in bf16 and the backward runs from the forward's saved
statistics, as ``FlashAttention`` hands them over.  Time: ms per call,
the least of ``repeats`` runs of 10 calls back to back (CUDA events).
Accuracy, one batch row at a time against the plain version in float32:
for dq, dk and dv the signed mean error over the mean |value| (``drift``;
negative is toward zero) and the worst |error| over the check's limit
1e-3 + 2**-7 |plain| (``worst``; above 1 fails ``chip_smoke.py``).
Prints one JSON line with the card's name and power limit.  It calls only
``flash_attention._forward``, ``flash_attention_bwd`` and the plain
version, which every checkout with the bf16 backward has, so the same
file measures an older checkout when ``PYTHONPATH`` points at its ``src``.

With ``--against``, ``turns`` times the order this, other, other, this,
each run a process of its own; prints each process's line, then each
version's least ms per shape over its processes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

#: name -> (B, S, H, Hkv, D)
SHAPES = {
    "stablelm-1.6b 32/32 D64": (2, 2048, 32, 32, 64),
    "gemma3-27b 32/16 D128": (2, 2048, 32, 16, 128),
    "qwen2-vl-7b 28/4 D128": (2, 2048, 28, 4, 128),
    "granite-20b 48/1 D128": (2, 2048, 48, 1, 128),
    "1/1 D128": (2, 2048, 1, 1, 128),
    "48/12 D128": (2, 2048, 48, 12, 128),
    "16/1 D128": (2, 2048, 16, 1, 128),
    "48/1 D64": (2, 2048, 48, 1, 64),
    "48/1 D128 S4096": (2, 4096, 48, 1, 128),
}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def measure(shape, repeats: int, seed: int = 7) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    stats = fa._forward(q, k, v, pos, pos, True, None, None, stats=True)[1:]
    call = lambda: fa.flash_attention_bwd(q, k, v, do, pos, pos, stats=stats)
    got = call()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            call()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 10)
    out = {"ms": min(runs), "runs_ms": runs}
    for i, name in enumerate(("dq", "dk", "dv")):
        drift = worst = 0.0
        for r in range(b):
            row = lambda t: t[r:r + 1].float()
            plain = ref.flash_attention_bwd_ref(row(q), row(k), row(v), row(do), pos,
                                                pos)[i]
            err = row(got[i]) - plain
            drift += float((err * plain.sign()).mean() / plain.abs().mean()) / b
            worst = max(worst, float((err.abs() / (1e-3 + 2**-7 * plain.abs())).max()))
        out[name] = {"drift": drift, "worst": worst}
    return out


def compare(other: Path, turns: int, repeats: int) -> dict:
    here = Path(__file__).resolve().parents[2]
    versions = {"this": here, "other": other.resolve()}
    least = {name: {} for name in versions}
    for _ in range(turns):
        for name in ("this", "other", "other", "this"):
            env = dict(os.environ, PYTHONPATH=str(versions[name]))
            proc = subprocess.run([sys.executable, __file__, "--repeats", str(repeats)],
                                  env=env, capture_output=True, text=True, check=True)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec.update(version=name, src=str(versions[name]))
            print(json.dumps(rec), flush=True)
            for shape, m in rec["shapes"].items():
                least[name][shape] = min(least[name].get(shape, m["ms"]), m["ms"])
    return {"least_ms": least, "processes": 2 * turns, "card": card()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's src: compare the two in turns")
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd.py needs a CUDA device")
    if args.against is not None:
        print(json.dumps(compare(args.against, args.turns, args.repeats)))
        return 0
    print(json.dumps({"shapes": {name: measure(shape, args.repeats)
                                 for name, shape in SHAPES.items()}, "card": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
