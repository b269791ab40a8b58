"""Fused error feedback + uniform quantization (no pack).

Counterpart of ``repro.kernels.quantize_ef``: one sweep reads ``msg`` and
``cache`` and writes the level indices and the new cache,

    corrected = msg + cache                                  (float32)
    wire      = clip(floor((clip(corrected) − vmin)/Δ + 0.5), 0, L)
    new_cache = corrected − (wire·Δ + vmin)                  (msg's dtype)

with the wire as uint8 for L ≤ 255, else uint16.  msg and cache are each
float32, bf16 or fp16, as the JAX kernel takes any float dtypes; with no
cache (``cache=None``) it writes only the wire of msg, which is
``quantize_encode(msg)``.  It rounds as :mod:`.compress_pipeline` does, so
its wire is the unpack of ``quant_pipeline``'s words and the new caches
agree bit for bit.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/quantize_ef.cu``, one launch
for any size (64-bit n).
"""
from __future__ import annotations

import torch

from ..core.compression import quant_constants
from . import _build, ref

__all__ = ["quantize_ef"]

#: element types the kernel reads and writes, by its type code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_ef(msg, cache, *, levels: int = 255, vmin: float = -0.25,
                vmax: float = 0.25):
    """(msg, cache) → (wire uint8/uint16, new cache), both in msg's shape,
    the new cache in msg's dtype; (msg, None) → (wire, None)."""
    ref.wire_dtype(levels)                   # L ≤ 65535: a uint8 or uint16 wire
    if msg.device.type == "cpu":
        return ref.quantize_ef_ref(msg, cache, levels=levels, vmin=vmin,
                                   vmax=vmax)
    pair = (msg,) if cache is None else (msg, cache)
    if any(t.dtype not in DTYPE_CODES for t in pair):
        raise TypeError(f"quantize_ef takes msg and cache of {tuple(DTYPE_CODES)}, "
                        f"got {', '.join(str(t.dtype) for t in pair)}")
    if cache is not None and (msg.shape != cache.shape or cache.device != msg.device):
        raise ValueError("msg and cache must have one shape and one device")
    msg = msg.contiguous()
    cache = None if cache is None else cache.contiguous()
    wire = torch.empty(msg.shape, dtype=ref.wire_dtype(levels), device=msg.device)
    new_cache = None if cache is None else torch.empty_like(msg)
    n = msg.numel()
    if n:
        delta, recip, _ = quant_constants(levels, vmin, vmax)
        _build.launch("quantize_ef", msg, cache, wire, new_cache, n, levels,
                      vmin, vmax, delta, recip, DTYPE_CODES[msg.dtype],
                      DTYPE_CODES[pair[-1].dtype])
    return wire, new_cache
