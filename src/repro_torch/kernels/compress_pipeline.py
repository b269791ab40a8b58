"""Fused error-feedback → quantize → bit-pack uplink.

Counterpart of ``repro.kernels.compress_pipeline.quant_pipeline``: one
sweep reads ``msg`` and ``cache`` and writes the packed wire words and the
new cache,

    corrected = msg + cache
    idx       = clip(floor((clip(corrected) − vmin)/Δ + 0.5), 0, L)
    words     = pack(idx)  at b = ceil(log2(L+1)) bits
    new_cache = corrected − (idx·Δ + vmin)

with the tile layout of :mod:`.pack_bits`, so the words equal
``pack_bits(quantize_encode(msg + cache))`` word for word.  Slots past the
data pack as index 0 (the JAX kernel pads msg with vmin and cache with 0).

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/quant_pipeline.cu``.
"""
from __future__ import annotations

import torch

from ..core.compression import quant_constants, wire_index_bits
from . import _build, ref
from .pack_bits import LANES, R, _TILE_VALS, check_cuda_size, n_tiles

__all__ = ["quant_pipeline", "pipeline_tile_values"]

#: values per kernel tile (same tile as pack_bits: (32·R, 128) = 32768)
pipeline_tile_values = _TILE_VALS


def quant_pipeline(msg, cache, *, levels: int = 255, vmin: float = -1.0,
                   vmax: float = 1.0):
    """Fused quantize + EF + pack: (msg, cache) → (wire words, new cache).

    ``words`` is a flat uint32 tensor of ``tiles·bits·R·LANES`` words;
    ``new_cache`` has the shape and dtype of ``msg``.
    """
    bits = wire_index_bits(levels)
    if msg.device.type == "cpu":
        return ref.quant_pipeline_ref(msg, cache, levels=levels, vmin=vmin,
                                      vmax=vmax)
    if msg.dtype != torch.float32 or cache.dtype != torch.float32:
        raise TypeError(f"quant_pipeline takes float32 msg and cache, got "
                        f"{msg.dtype} and {cache.dtype}")
    if msg.shape != cache.shape or cache.device != msg.device:
        raise ValueError("msg and cache must have one shape and one device")
    if levels >= 2**31:
        raise ValueError(f"levels={levels} exceeds the kernel's int range")
    msg, cache = msg.contiguous(), cache.contiguous()
    n = msg.numel()
    check_cuda_size(n)
    tiles = n_tiles(n)
    words = torch.empty(tiles * bits * R * LANES, dtype=torch.uint32,
                        device=msg.device)
    new_cache = torch.empty_like(msg)
    delta, recip, _ = quant_constants(levels, vmin, vmax)
    _build.launch("quant_pipeline", msg, cache, words, new_cache, n, bits,
                  tiles, levels, vmin, vmax, delta, recip)
    return words, new_cache
