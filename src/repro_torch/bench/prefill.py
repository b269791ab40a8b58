"""Prefill time of a dense LM at full width on the card, at short prompts.

    PYTHONPATH=src python src/repro_torch/bench/prefill.py \\
        [--arch h2o-danube-3-4b] [--batch 1] [--prompts 512 1024] [--repeats 7]

Draws bf16 weights at random from a seed, runs one prefill per prompt
length to warm up and then times ``repeats`` more with the host clock
around work ending in a synchronize.  At these lengths a prefill is bound
by the host's launches, so the wrappers' host time shows here where a
long prompt hides it.  Prints one JSON line per prompt length: the least
and the median ms, tokens/s at the least, and the kernels launched by one
prefill.  It uses only the serving API that the port has had since it
began to serve, so the same file times an older checkout of the port
when ``PYTHONPATH`` points at that checkout's ``src``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def prefill_times(arch: str, batch: int, prompts, repeats: int, seed: int = 0):
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.transformer import init_params
    cfg = get(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, generator=gen, device="cuda")
    prefill = make_prefill_step(cfg)
    out = []
    for s in prompts:
        tokens = torch.randint(0, cfg.vocab_size, (batch, s), generator=gen, device="cuda")
        prefill(params, {"tokens": tokens})
        ops.reset_launch_counts()
        prefill(params, {"tokens": tokens})
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        runs = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"prefill at S={s}: logits not finite")
        out.append({"arch": arch, "batch": batch, "prompt": s, "ms": min(runs),
                    "median_ms": statistics.median(runs), "runs_ms": runs,
                    "tok_s": batch * s / min(runs) * 1e3, "launches": launches})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompts", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prefill.py needs a CUDA device")
    import repro_torch
    repro_torch.set_float32_precision()
    for rec in prefill_times(args.arch, args.batch, args.prompts, args.repeats):
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
