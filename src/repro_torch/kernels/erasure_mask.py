"""Counter-hash erasure mask over packed wire words.

Counterpart of ``repro.kernels.erasure_mask``: the device-side sibling of
the host ARQ model (:mod:`repro_torch.channel`).  Given the uint32 words
of a cohort's packed uplink, it decides per *segment* of
``segment_words`` consecutive words whether the channel erased it, and
zeroes the erased words.  The fate of word ``i`` depends only on
``(seed, i // segment_words)``: a murmur3 finalizer hashes the segment
counter, and the segment is erased when ``hash < drop_threshold(p)``.
So the same (seed, counter) gives the same decision on any device and
for any launch shape, word for word with the Pallas kernel.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/erasure_mask.cu``.
"""
from __future__ import annotations

import torch

from . import _build
from .pack_bits import check_cuda_size
from .ref import _MASK32, drop_threshold, erasure_mask_ref, segment_hash

__all__ = ["drop_threshold", "segment_hash", "erasure_mask"]


def erasure_mask(words, *, p: float, seed: int = 0, segment_words: int = 32):
    """Erase segments of a packed word stream → ``(masked, keep)``.

    ``words``: any-shape uint32 tensor, flattened in C order; segment ``s``
    covers flat words ``[s·segment_words, (s+1)·segment_words)``.  Each
    segment is erased with probability ``p`` (the counter hash of ``s``
    under ``seed``); erased words are zeroed.  ``keep`` is uint32 0/1 per
    word; both outputs have the input's shape.
    """
    if segment_words < 1:
        raise ValueError(f"segment_words must be >= 1, got {segment_words}")
    if words.device.type == "cpu":
        return erasure_mask_ref(words, p=p, seed=seed,
                                segment_words=segment_words)
    if words.dtype != torch.uint32:
        raise TypeError(f"words must be uint32, got {words.dtype}")
    if segment_words > _MASK32:
        raise ValueError(f"segment_words={segment_words} exceeds uint32")
    n = words.numel()
    check_cuda_size(n)
    flat = words.contiguous()
    masked = torch.empty_like(flat)
    keep = torch.empty_like(flat)
    _build.launch("erasure_mask", flat, masked, keep, n, int(segment_words),
                  seed & _MASK32, (seed >> 32) & _MASK32, drop_threshold(p))
    return masked, keep
