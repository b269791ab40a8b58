"""Fused error-feedback → compress → bit-pack uplinks.

Counterpart of ``repro.kernels.compress_pipeline``.  ``quant_pipeline``:
one sweep reads ``msg`` and ``cache`` and writes the packed wire words and
the new cache,

    corrected = msg + cache
    idx       = clip(floor((clip(corrected) − vmin)/Δ + 0.5), 0, L)
    words     = pack(idx)  at b = ceil(log2(L+1)) bits
    new_cache = corrected − (idx·Δ + vmin)

with the tile layout of :mod:`.pack_bits`, so the words equal
``pack_bits(quantize_encode(msg + cache))`` word for word.  Slots past the
data pack as index 0 (the JAX kernel pads msg with vmin and cache with 0).

``sign_pipeline``: the 1-bit scaled sign (ScaledSign, sign(0) := +1),

    corrected = msg + cache
    scale     = mean |corrected|      (reduced inside the same launch)
    words     = pack(corrected >= 0)  at b = 1
    new_cache = corrected − (±scale)

with slots past the data packed as bit 0 (the JAX kernel pads msg with −1
and cache with 0).  On the card it is one cooperative launch: a pass that
sums |corrected| into one float64 partial per chunk of
:data:`SIGN_CHUNK_VALUES` values, a grid-wide sync, the scale from all
partials in one fixed order (so it does not depend on the grid), and a
pass that writes words and new cache.  The wrapper runs no torch op on the
device; it only allocates.  No path of the JAX package calls it: its entry
point is ``ops.sign_pipeline``, and the port's is the same.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/quant_pipeline.cu`` or
``csrc/sign_pipeline.cu``.
"""
from __future__ import annotations

import torch

from ..core.compression import quant_constants, wire_index_bits
from . import _build, ref
from .pack_bits import GROUP, LANES, R, _TILE_VALS, check_cuda_size, n_tiles

__all__ = ["quant_pipeline", "sign_pipeline", "pipeline_tile_values"]

#: values per kernel tile (same tile as pack_bits: (32·R, 128) = 32768)
pipeline_tile_values = _TILE_VALS
#: csrc/sign_pipeline.cu: threads per block, neighbouring columns per
#: thread (a quad), and quads per chunk (one per lane of a warp); a chunk
#: of 32 rows of 128 columns is the unit of one float64 partial of the scale
SIGN_THREADS, SIGN_COLS, SIGN_CHUNK_QUADS = 256, 4, 32
SIGN_CHUNK_VALUES = GROUP * SIGN_COLS * SIGN_CHUNK_QUADS
SIGN_CHUNKS_PER_TILE = _TILE_VALS // SIGN_CHUNK_VALUES


def _check_pair(name: str, msg, cache, dtypes=(torch.float32,)) -> None:
    if msg.dtype not in dtypes or cache.dtype != msg.dtype:
        raise TypeError(f"{name} takes msg and cache of one dtype of {dtypes}, got "
                        f"{msg.dtype} and {cache.dtype}")
    if msg.shape != cache.shape or cache.device != msg.device:
        raise ValueError("msg and cache must have one shape and one device")


def quant_pipeline(msg, cache, *, levels: int = 255, vmin: float = -1.0,
                   vmax: float = 1.0):
    """Fused quantize + EF + pack: (msg, cache) → (wire words, new cache).

    ``words`` is a flat uint32 tensor of ``tiles·bits·R·LANES`` words;
    ``new_cache`` has the shape and dtype of ``msg``.  On the card msg and
    cache are float32 or bf16, one dtype for both: the sweep computes in
    float32 and writes the new cache in msg's dtype, as the JAX kernel
    does, so a bf16 model's uplink needs no cast.
    """
    bits = wire_index_bits(levels)
    if msg.device.type == "cpu":
        return ref.quant_pipeline_ref(msg, cache, levels=levels, vmin=vmin,
                                      vmax=vmax)
    _check_pair("quant_pipeline", msg, cache, (torch.float32, torch.bfloat16))
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
                  tiles, levels, vmin, vmax, delta, recip,
                  int(msg.dtype == torch.bfloat16))
    return words, new_cache


def sign_pipeline(msg, cache):
    """Fused scaled sign + EF + 1-bit pack: (msg, cache) → (words, scale,
    new cache).

    ``words`` is a flat uint32 tensor of ``tiles·R·LANES`` words, ``scale``
    a float32 scalar tensor, ``new_cache`` in the shape and dtype of msg.
    On the card all three come from one launch; msg and cache are float32
    or bf16, one dtype for both: the launch computes in float32 and writes
    the new cache in msg's dtype, as the JAX kernel does.  They may be views
    of any alignment (one off a quad's 16 or 8 bytes is read value by value).
    """
    if msg.device.type == "cpu":
        return ref.sign_pipeline_ref(msg, cache)
    _check_pair("sign_pipeline", msg, cache, (torch.float32, torch.bfloat16))
    msg, cache = msg.contiguous(), cache.contiguous()
    n = msg.numel()
    if n == 0:
        raise ValueError("sign_pipeline needs at least one value (its scale "
                         "is a mean)")
    check_cuda_size(n)
    tiles = n_tiles(n)
    words = torch.empty(tiles * R * LANES, dtype=torch.uint32, device=msg.device)
    new_cache = torch.empty_like(msg)
    scale = torch.empty((), dtype=torch.float32, device=msg.device)
    partials = torch.empty(tiles * SIGN_CHUNKS_PER_TILE, dtype=torch.float64,
                           device=msg.device)
    _build.launch("sign_pipeline", msg, cache, words, new_cache, scale, partials,
                  n, tiles, int(msg.dtype == torch.bfloat16))
    return words, scale, new_cache
