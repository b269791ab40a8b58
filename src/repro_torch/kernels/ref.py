"""Plain PyTorch versions of the port's kernels.

They run on any device.  The CPU tests hold them against the JAX
package's Pallas kernels, word for word; on the card ``chip_smoke.py``
holds each CUDA kernel against them, bit for bit.

Integer work is done in int64 masked with ``0xFFFFFFFF``: PyTorch on the
CPU has no ``>>``, ``<<`` or ``+`` on ``torch.uint32``.  A uint32 tensor is
read through an int32 view and written back the same way, so no uint32
arithmetic or cast kernel is needed on either device.
"""
from __future__ import annotations

import torch

from ..core.compression import decode_levels, level_index, wire_index_bits
from .pack_bits import GROUP, LANES, R, _TILE_VALS, _check_bits, n_tiles

_MASK32 = 0xFFFFFFFF


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """Integer tensor (uint32 included) as int64 with the same values."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & _MASK32
    return t.to(torch.int64)


def to_uint32(t64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as a uint32 tensor."""
    t64 = t64 & _MASK32
    return torch.where(t64 >= 2**31, t64 - 2**32, t64).to(torch.int32).view(
        torch.uint32)


def _quantize_ef(msg, cache, levels, vmin, vmax):
    """Level indices (float32) and new cache of the EF uplink step."""
    corrected = msg.to(torch.float32) + cache.to(torch.float32)
    idx = level_index(torch.clamp(corrected, vmin, vmax), levels, vmin, vmax)
    idx = torch.clamp(idx, 0, levels)
    decoded = decode_levels(idx, levels, vmin, vmax)
    return idx, (corrected - decoded).to(msg.dtype)


def quantize_ef_ref(msg, cache, *, levels: int, vmin: float, vmax: float):
    """Fused uplink step (paper Alg. 2 lines 15–16):

        corrected = msg + cache
        wire      = level_index(clip(corrected))      (uint8/uint16)
        new_cache = corrected − decode(wire)

    Returns (wire, new_cache).
    """
    idx, new_cache = _quantize_ef(msg, cache, levels, vmin, vmax)
    dtype = torch.uint8 if levels <= 255 else torch.uint16
    return idx.to(torch.int32).to(dtype), new_cache


def pack_bits_ref(x, bits: int):
    """Plain version of :func:`repro_torch.kernels.pack_bits.pack_bits`.

    Value ``i`` of group ``(r, lane)`` sits at row ``i·R + r`` of a
    (32·R, 128) tile; bit j of value i goes to bit i of word j, and word j
    sits at row ``j·R + r`` of the (b·R, 128) word tile.
    """
    _check_bits(bits)
    n = x.numel()
    tiles = n_tiles(n)
    flat = torch.zeros(tiles * _TILE_VALS, dtype=torch.int64, device=x.device)
    flat[:n] = as_int64(x.reshape(-1)) & _MASK32
    v = flat.reshape(tiles, GROUP, R, LANES)
    shift_i = torch.arange(GROUP, device=x.device).reshape(1, GROUP, 1, 1)
    words = torch.stack([(((v >> j) & 1) << shift_i).sum(dim=1)
                         for j in range(bits)], dim=1)   # (T, b, R, LANES)
    return to_uint32(words.reshape(-1))


def unpack_bits_ref(words, bits: int, n: int):
    """Plain version of :func:`repro_torch.kernels.pack_bits.unpack_bits`."""
    _check_bits(bits)
    tiles = words.numel() // (bits * R * LANES)
    w = as_int64(words).reshape(tiles, bits, 1, R, LANES)
    shift_i = torch.arange(GROUP, device=words.device).reshape(1, GROUP, 1, 1)
    vals = torch.zeros((tiles, GROUP, R, LANES), dtype=torch.int64,
                       device=words.device)
    for j in range(bits):
        vals |= ((w[:, j] >> shift_i) & 1) << j
    return to_uint32(vals.reshape(-1)[:n])


def quant_pipeline_ref(msg, cache, *, levels: int, vmin: float, vmax: float):
    """Plain version of
    :func:`repro_torch.kernels.compress_pipeline.quant_pipeline`:
    quantize+EF, then the transposed bit-plane pack of the indices, so
    ``words == pack_bits_ref(wire)`` and
    ``new_cache == (msg + cache) − decode(wire)``.
    """
    idx, new_cache = _quantize_ef(msg, cache, levels, vmin, vmax)
    words = pack_bits_ref(idx.to(torch.int64), wire_index_bits(levels))
    return words, new_cache
