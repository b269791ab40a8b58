"""Fused error feedback + uniform quantization (no pack).

Counterpart of ``repro.kernels.quantize_ef``: one sweep reads ``msg`` and
``cache`` and writes the level indices and the new cache,

    corrected = msg + cache
    wire      = clip(floor((clip(corrected) − vmin)/Δ + 0.5), 0, L)
    new_cache = corrected − (wire·Δ + vmin)

with the wire as uint8 for L ≤ 255, else uint16.  It rounds as
:mod:`.compress_pipeline` does, so its wire is the unpack of
``quant_pipeline``'s words and the new caches agree bit for bit.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/quantize_ef.cu``.
"""
from __future__ import annotations

import torch

from ..core.compression import quant_constants
from . import _build, ref
from .pack_bits import check_cuda_size

__all__ = ["quantize_ef"]


def quantize_ef(msg, cache, *, levels: int = 255, vmin: float = -0.25,
                vmax: float = 0.25):
    """(msg, cache) → (wire uint8/uint16, new cache), both in msg's shape."""
    if msg.device.type == "cpu":
        return ref.quantize_ef_ref(msg, cache, levels=levels, vmin=vmin,
                                   vmax=vmax)
    if msg.dtype != torch.float32 or cache.dtype != torch.float32:
        raise TypeError(f"quantize_ef takes float32 msg and cache, got "
                        f"{msg.dtype} and {cache.dtype}")
    if msg.shape != cache.shape or cache.device != msg.device:
        raise ValueError("msg and cache must have one shape and one device")
    if not 1 <= levels <= 65535:
        raise ValueError(f"levels={levels}: the wire is uint8 or uint16")
    msg, cache = msg.contiguous(), cache.contiguous()
    n = msg.numel()
    check_cuda_size(n)
    wire = torch.empty(msg.shape, dtype=ref.wire_dtype(levels),
                       device=msg.device)
    new_cache = torch.empty_like(msg)
    delta, recip, _ = quant_constants(levels, vmin, vmax)
    _build.launch("quantize_ef", msg, cache, wire, new_cache, n, levels,
                  vmin, vmax, delta, recip)
    return wire, new_cache
