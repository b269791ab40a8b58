"""The attention backward on the card: time and drift by group size.

    PYTHONPATH=src python src/repro_torch/bench/attention_bwd.py [--repeats 3]
    PYTHONPATH=src python src/repro_torch/bench/attention_bwd.py \\
        --against OTHER/src [--turns 1] [--repeats 3]
    PYTHONPATH=src python src/repro_torch/bench/attention_bwd.py --dtype float32

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

``--dtype float32`` measures the float32 route (``flash_attention_bwd.cu``)
at F32_SHAPES instead, in float32 throughout: ms per call, the dK/dV
grid's blocks, and for dq, dk and dv the drift and the worst |error| over
the check's 1e-4; and dK's worst |error| against a float64 plain version
(autograd), for the kernel and for the float32 plain version.
"""
from __future__ import annotations

import argparse
import json
import math
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


#: name -> (B, S, H, Hkv, D) of the float32 route: the catalog's training
#: shapes (groups 1, 2, 7 and 48) and MQA at D 64
F32_SHAPES = {
    "stablelm-1.6b 32/32 D64": (2, 2048, 32, 32, 64),
    "gemma3-27b 32/16 D128": (2, 2048, 32, 16, 128),
    "qwen2-vl-7b 28/4 D128": (2, 2048, 28, 4, 128),
    "granite-20b 48/1 D128": (2, 2048, 48, 1, 128),
    "48/1 D64": (2, 2048, 48, 1, 64),
}
F32_ATOL = 1e-4


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
    runs = time_call(call, repeats)
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


def time_call(call, repeats: int) -> list:
    """ms per call of ``repeats`` runs of 10 calls back to back (CUDA events)."""
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
    return runs


def dk_f64(q, k, v, do, pos, window=None):
    """dK of the plain attention (causal, ``window``, no softcap; q, k, v,
    dO (B, S, H or Hkv, D) at positions ``pos``) in float64 by autograd:
    the yardstick that the float32 routes, kernel and plain version, are
    both measured against."""
    from repro_torch.kernels import ref
    n_rep = q.shape[2] // k.shape[2]
    q, v, do = (t.double() for t in (q, v, do))
    k = k.double().requires_grad_()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(n_rep, dim=2))
    ok = ref.attention_mask(pos, pos, causal=True, window=window)
    p = torch.softmax((s / math.sqrt(q.shape[-1])).masked_fill(~ok, -1e30), dim=-1)
    del s
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(n_rep, dim=2))
    return torch.autograd.grad(o, k, do)[0]


def measure_f32(shape, repeats: int, seed: int = 7) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda") for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda")
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    stats = fa._forward(q, k, v, pos, pos, True, None, None, stats=True)[1:]
    call = lambda: fa.flash_attention_bwd(q, k, v, do, pos, pos, stats=stats)
    got = call()
    slices = fa.f32_bwd_head_slices(h // hkv, s)
    out = {"dkdv_blocks": b * hkv * -(-s // fa.BWD_BLOCK_K) * len(slices),
           "slices": len(slices)}
    runs = time_call(call, repeats)
    out.update(ms=min(runs), runs_ms=runs)
    dk_err = {"kernel_f64": 0.0, "plain_f64": 0.0}
    for i, name in enumerate(("dq", "dk", "dv")):
        drift = worst = 0.0
        for r in range(b):
            row = lambda t: t[r:r + 1]
            plain = ref.flash_attention_bwd_ref(row(q), row(k), row(v), row(do), pos,
                                                pos)[i]
            err = row(got[i]) - plain
            drift += float((err * plain.sign()).mean() / plain.abs().mean()) / b
            worst = max(worst, float(err.abs().max()) / F32_ATOL)
            if name == "dk":
                d64 = dk_f64(row(q), row(k), row(v), row(do), pos)
                dk_err["kernel_f64"] = max(dk_err["kernel_f64"],
                                           float((row(got[1]).double() - d64).abs().max()))
                dk_err["plain_f64"] = max(dk_err["plain_f64"],
                                          float((plain.double() - d64).abs().max()))
                del d64
        out[name] = {"drift": drift, "worst": worst}
    out["dk_abs_err"] = dk_err
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd.py needs a CUDA device")
    if args.dtype == "float32":
        from repro_torch.device import resolve_device
        resolve_device("cuda")
        print(json.dumps({"dtype": "float32", "card": card(), "shapes": {
            name: measure_f32(shape, args.repeats)
            for name, shape in F32_SHAPES.items()}}))
        return 0
    if args.against is not None:
        print(json.dumps(compare(args.against, args.turns, args.repeats)))
        return 0
    print(json.dumps({"shapes": {name: measure(shape, args.repeats)
                                 for name, shape in SHAPES.items()}, "card": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
