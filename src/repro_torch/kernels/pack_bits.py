"""Bit pack / unpack for the on-wire codec layer.

Counterpart of the JAX package's Pallas kernels ``repro.kernels.pack_bits``,
with the same wire layout word for word: values go in groups of 32, a
group of b-bit values packs into b ``uint32`` words with **bit j of value
i at bit i of word j**, and groups are stacked ``R`` deep and ``LANES``
wide into tiles of ``GROUP·R·LANES`` values.  Value ``i`` of group
``(r, lane)`` of a tile sits at row ``i·R + r`` of a (32·R, 128) value
tile and its word ``j`` at row ``j·R + r`` of a (b·R, 128) word tile.
``GROUP``, ``R`` and ``LANES`` are layout constants: words packed here
decode in the JAX package and the other way round.

The word buffer keeps the tile padding (``tiles·b·R·LANES`` words, zero
past the data); the logical on-wire size is ``ceil(n/32)·b`` words.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/pack_bits.cu``.  Its
``unpack_bits`` runs one block of :data:`UNPACK_THREADS` threads per tile,
thread t on columns ``UNPACK_COLS·t ..`` of it: one 16-byte load per word
plane when the word buffer's base is 16-byte aligned (four 4-byte loads
when it is not, as for a view into a wire payload) and one streaming
16-byte store per value row, value by value where a group of four
crosses n.
"""
from __future__ import annotations

import torch

from . import _build

LANES = 128     # lanes of a tile row
GROUP = 32      # values per packed group (= bits per uint32 word)
R = 8           # groups stacked per tile (tile rows = 32·R)

_TILE_VALS = GROUP * R * LANES
#: csrc/pack_bits.cu unpack_bits: threads per block (a block per tile) and
#: neighbouring columns per thread
UNPACK_THREADS, UNPACK_COLS = 256, 4


def _check_bits(bits: int) -> None:
    if not (1 <= int(bits) <= 32):
        raise ValueError(f"bit width must be in [1, 32], got {bits}")


def logical_words(n: int, bits: int) -> int:
    """On-wire ``uint32`` word count for ``n`` b-bit values (no tile pad)."""
    _check_bits(bits)
    return -(-n // GROUP) * bits


def n_tiles(n: int) -> int:
    """Tiles that hold ``n`` values (at least one, as in the JAX kernels)."""
    return max(1, -(-n // _TILE_VALS))


def check_cuda_size(n: int) -> None:
    """The kernels index with ``int`` sizes."""
    if n >= 2**31:
        raise ValueError(f"{n} values exceed the kernels' int sizes")


def pack_bits(x, bits: int):
    """Pack ``x`` (any shape, integer values < 2**bits) into uint32 words.

    Returns a flat uint32 tensor of ``tiles·bits·R·LANES`` words, the
    tile padding packed as zero values; ``logical_words(x.numel(), bits)``
    is what the wire carries.  No value (an empty sparse payload) gives
    one tile of zero words, as in the JAX package, with no launch.
    """
    _check_bits(bits)
    if x.device.type == "cpu":
        from .ref import pack_bits_ref  # lazy: ref imports this module
        return pack_bits_ref(x, bits)
    from .ref import as_int64, to_uint32
    flat = x.reshape(-1)
    if flat.dtype != torch.uint32:
        flat = to_uint32(as_int64(flat))
    flat = flat.contiguous()
    n = flat.numel()
    check_cuda_size(n)
    tiles = n_tiles(n)
    if n == 0:
        return torch.zeros(tiles * bits * R * LANES, dtype=torch.uint32,
                           device=x.device)
    words = torch.empty(tiles * bits * R * LANES, dtype=torch.uint32,
                        device=x.device)
    _build.launch("pack_bits", flat, words, n, bits, tiles)
    return words


def unpack_bits(words, bits: int, n: int):
    """Inverse of :func:`pack_bits`: the first ``n`` values, flat uint32
    (no launch for ``n = 0``)."""
    _check_bits(bits)
    tiles = words.numel() // (bits * R * LANES)
    if tiles * bits * R * LANES != words.numel():
        raise ValueError(f"word buffer size {words.numel()} is not a whole "
                         f"number of ({bits}·{R}·{LANES})-word tiles")
    if n > tiles * _TILE_VALS:
        raise ValueError(f"cannot unpack {n} values from {tiles} tile(s)")
    if words.device.type == "cpu":
        from .ref import unpack_bits_ref
        return unpack_bits_ref(words, bits, n)
    if words.dtype != torch.uint32:
        raise TypeError(f"words must be uint32, got {words.dtype}")
    check_cuda_size(words.numel())
    words = words.reshape(-1).contiguous()
    vals = torch.empty(n, dtype=torch.uint32, device=words.device)
    if n == 0:
        return vals
    _build.launch("unpack_bits", words, vals, n, bits, tiles)
    return vals
