"""Serving example: batched prefill + decode with the KV/SSM cache.

Counterpart of the JAX package's ``examples/serve_lm.py``.  Serves the
coordinator model over a batch of token prompts: one prefill step builds
the cache, then greedy decode streams tokens, through
``launch/serve.py``'s steps.  Works for any catalog architecture's smoke
variant (``--arch``), demonstrating cache handling across attention,
sliding-window, MoE, Mamba2 and RWKV6 blocks.  As in the reference, the
steps take the ``xla`` backend, which in the port is the plain attention.

Run (on the card):  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mixtral-8x7b --tokens 16
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, smoke_variant
from ..device import resolve_device
from ..launch.serve import make_decode_step, make_prefill_step
from ..models.transformer import init_params


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None) -> torch.Tensor:
    """Run the example; returns the generated tokens (batch, tokens)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = smoke_variant(ARCHS[args.arch])
    if cfg.arch_type == "vlm":
        print("note: VLM smoke serve uses text tokens only")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)

    prefill = make_prefill_step(cfg, backend="xla")
    decode = make_decode_step(cfg, backend="xla")

    t0 = time.time()
    logits, cache = prefill(params, {"tokens": prompts})
    tok = logits.argmax(-1, keepdim=True)
    _sync(dev)
    print(f"prefill {args.batch}×{args.prompt_len} in {time.time()-t0:.2f}s")

    out = [tok]
    t0 = time.time()
    for _ in range(args.tokens - 1):
        logits, cache = decode(params, cache, tok)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    dt = time.time() - t0
    gen = torch.cat(out, dim=1)
    print(f"decoded {args.tokens - 1} steps in {dt:.2f}s "
          f"({(args.tokens - 1) * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
