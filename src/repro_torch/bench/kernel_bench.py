"""Micro-benchmarks: the port's CUDA kernels against their plain versions.

Counterpart of ``benchmarks/kernel_bench.py``: ``quantize_ef`` at 2**20
values (the per-round uplink hot spot) and the float32 ``flash_attention``
at B 1, S 1024, H 4, D 128, causal (prefill), each kernel timed against
its plain version in :mod:`repro_torch.kernels.ref` with
:func:`repro_torch.bench.timing.time_fn` (host clock ended by
``torch.cuda.synchronize()``, least of the timed calls; so a call's time
includes its host dispatch).  Beside each it prints the card's bound
(the H100 SXM data sheet, at a 700 W power limit): bytes at 3.35 TB/s,
and float32 attention's products as three TF32 products at 495 TFLOP/s,
with the 67 TFLOP/s FMA rate beside it; and the card's name and power
limit.  On the CPU (``device="cpu"``) both sides are plain versions and no
bound is a device number.

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench
"""
from __future__ import annotations

import torch

from ..device import device_label, resolve_device
from ..kernels import ref
from ..kernels.flash_attention import flash_attention
from ..kernels.quantize_ef import quantize_ef
from .timing import time_fn

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
TF32_OPS_PER_S = 495e12       # tensor cores, TF32, dense
FP32_OPS_PER_S = 67e12        # float32 FMA outside the tensor cores
REPS, WARMUP = 20, 3


def _us(fn) -> float:
    return time_fn(fn, reps=REPS, warmup=WARMUP) * 1e6


def _share(bound_us: float, us: float, dev) -> str:
    """The share of the card's bound; a CPU time is no share of it."""
    if dev.type != "cuda":
        return "not measured (CPU)"
    return f"{bound_us / us:.4f}"


def main(device=None) -> dict:
    """Prints ``name,us_per_call,derived`` lines; returns the numbers."""
    dev = resolve_device(device)
    route = "cuda" if dev.type == "cuda" else "plain"
    label = device_label(dev)
    print(f"device: {label}")
    gen = torch.Generator().manual_seed(0)

    # quantize+EF: the per-round uplink hot spot
    n = 1 << 20
    msg = (torch.randn(n, generator=gen) * 0.1).to(dev)
    cache = torch.zeros(n, device=dev)
    us_k = _us(lambda: quantize_ef(msg, cache))
    us_r = _us(lambda: ref.quantize_ef_ref(msg, cache, levels=255,
                                           vmin=-0.25, vmax=0.25))
    nbytes = n * (4 + 4 + 1 + 4)  # msg + cache reads, wire + cache writes
    q_bound_us = nbytes / HBM_BYTES_PER_S * 1e6
    print(f"quantize_ef_{route},{us_k:.1f},bound_us={q_bound_us:.2f} "
          f"(bytes),share={_share(q_bound_us, us_k, dev)}")
    print(f"quantize_ef_plain,{us_r:.1f},bytes={nbytes}")

    # flash attention: prefill hot spot
    b, s, h, d = 1, 1024, 4, 128
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev)
               for _ in range(3))
    pos = torch.arange(s, device=dev)
    us_f = _us(lambda: flash_attention(q, k, v, causal=True))
    us_fr = _us(lambda: ref.flash_attention_ref(q, k, v, pos, pos,
                                                causal=True))
    flops = 4 * b * h * s * s * d / 2
    f_bytes = 4 * b * s * h * d * 4      # q, k, v read, out written
    bytes_us = f_bytes / HBM_BYTES_PER_S * 1e6
    tf32_us = max(3 * flops / TF32_OPS_PER_S * 1e6, bytes_us)
    fma_us = max(flops / FP32_OPS_PER_S * 1e6, bytes_us)
    print(f"flash_attention_{route},{us_f:.1f},bound_us={tf32_us:.2f} "
          f"(operations: three TF32 products at 495 TFLOP/s),"
          f"share={_share(tf32_us, us_f, dev)},fma_bound_us={fma_us:.2f},"
          f"fma_share={_share(fma_us, us_f, dev)}")
    print(f"flash_attention_plain,{us_fr:.1f},flops={flops:.2e}")
    print(f"# on {label}")
    return {"device": label, "route": route,
            "quantize_ef": {"n": n, "us": us_k, "plain_us": us_r,
                            "bytes": nbytes, "bound_us": q_bound_us,
                            "bound_by": "bytes",
                            "bound_share": q_bound_us / us_k
                            if route == "cuda" else None},
            "flash_attention": {"shape": [b, s, h, d], "us": us_f,
                                "plain_us": us_fr, "flops": flops,
                                "bound_us": tf32_us,
                                "bound_by": "operations",
                                "bound_share": tf32_us / us_f
                                if route == "cuda" else None,
                                "fma_bound_us": fma_us,
                                "fma_share": fma_us / us_f
                                if route == "cuda" else None}}


if __name__ == "__main__":
    main()
