"""δ-approximate compressors (paper §2.4, Definitions 1–3).

A compressor is a callable ``C(gen, tree, batch=False) -> tree`` mapping a
tree of tensors to a tree of the same structure and shapes.  ``gen`` is a
``torch.Generator`` consumed only by stochastic compressors (rand-d);
deterministic ones ignore it.  With ``batch=True`` the leading axis of
every leaf indexes independent messages (one per agent), in place of the
JAX package's ``vmap`` over agents.

Implemented: :class:`UniformQuantizer` (Definition 2), :class:`RandD`
(Definition 3), :class:`TopK`, :class:`ScaledSign` and :class:`Identity`,
plus the integer on-wire codec :func:`quantize_encode` /
:func:`quantize_decode` matching ``UniformQuantizer(clip=True)``.

The quantizer's arithmetic is bit-exact with the JAX package as XLA
compiles it for the CPU, its quantizer and its Pallas kernels alike
(:func:`level_index`, :func:`decode_levels`): Δ is the float32 rounding of
``(vmax − vmin)/levels``; XLA turns the division by the constant Δ into a
multiplication by its float32 reciprocal and contracts each multiply and
add into one fused multiply-add.  Run op by op, uncompiled, the JAX
package divides and rounds twice instead, and can differ by one level at
a half-level boundary.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .pytree import tree_map, tree_split_keys


def wire_index_bits(levels: int) -> int:
    """Bit width of a uniform-quantizer level index: ceil(log2(L+1))."""
    return max(1, math.ceil(math.log2(levels + 1)))


def quant_constants(levels: int, vmin: float, vmax: float):
    """(Δ, 1/Δ, vmin) as the float32 values the compiled quantizer uses,
    returned as Python floats: Δ rounded to float32, its reciprocal
    computed and rounded in float32, vmin rounded to float32."""
    delta = np.float32((vmax - vmin) / levels)
    return float(delta), float(np.float32(1.0) / delta), float(np.float32(vmin))


def level_index(x, levels: int, vmin: float, vmax: float):
    """``floor((x − vmin)/Δ + 0.5)`` as float32, rounded as XLA computes it:
    ``floor(fma(x − vmin, 1/Δ, 0.5))`` with the float32 reciprocal.

    ``x − vmin`` is a float32 subtraction.  In float64 its product with the
    float32 reciprocal is exact, and so is adding 0.5 whenever the product
    is at least 2**-6 (below that the sum stays under 0.52 and the floor is
    0 either way), so rounding the float64 result to float32 gives the
    FMA's value on any device.  The CUDA kernel uses ``__fmaf_rn``.
    """
    _, recip, vmin32 = quant_constants(levels, vmin, vmax)
    c = (x - vmin32).to(torch.float64)
    return torch.floor((c * recip + 0.5).to(torch.float32))


def decode_levels(idx, levels: int, vmin: float, vmax: float):
    """Lattice points ``idx·Δ + vmin`` in float32, rounded once, as the FMA
    that XLA makes of them.  In float64 the product of an index below
    2**29 and a float32 Δ is exact, and so is the sum with the float32
    vmin for every quantizer the repository uses; the CUDA kernel uses
    ``__fmaf_rn``."""
    delta, _, vmin32 = quant_constants(levels, vmin, vmax)
    return (idx.to(torch.float64) * delta + vmin32).to(torch.float32)


class Compressor:
    """Base class; subclasses implement :meth:`compress_leaf`."""

    #: True if the compressor consumes random numbers.
    stochastic: bool = False

    def compress_leaf(self, gen, x, batch: bool = False):  # pragma: no cover
        raise NotImplementedError

    def __call__(self, gen, tree, batch: bool = False):
        if self.stochastic:
            if gen is None:
                raise ValueError(f"{type(self).__name__} draws random numbers "
                                 "and needs a torch.Generator")
            gens = tree_split_keys(gen, tree)
            return tree_map(lambda g, x: self.compress_leaf(g, x, batch),
                            gens, tree)
        return tree_map(lambda x: self.compress_leaf(None, x, batch), tree)

    def wire_bits_per_scalar(self) -> float:
        """Nominal on-wire cost (bits per element), payload only."""
        return 32.0

    def wire_codec(self):
        """Exact on-wire codec for this compressor (see :mod:`repro_torch.wire`)."""
        from ..wire.codecs import codec_for  # lazy: wire imports this module
        return codec_for(self)

    def wire_header_nbytes(self, ndim: int = 1) -> int:
        """Exact per-leaf header overhead of this compressor's codec."""
        codec = self.wire_codec()
        return 0 if codec is None else codec.leaf_header_nbytes(ndim)


def _rows(x, batch: bool):
    """``x`` as (messages, elements): one row per message."""
    return x.reshape(x.shape[0] if batch else 1, -1)


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    def compress_leaf(self, gen, x, batch: bool = False):
        return x


@dataclasses.dataclass(frozen=True)
class UniformQuantizer(Compressor):
    """Paper Definition 2.

    q(x) = Δ · floor((x − V_min)/Δ + 0.5) + V_min,  Δ = (V_max − V_min)/L.

    ``clip`` clamps inputs into [V_min, V_max] first; the paper's
    definition does not clip, so it defaults to False.
    """

    levels: int = 1000
    vmin: float = -10.0
    vmax: float = 10.0
    clip: bool = False

    def compress_leaf(self, gen, x, batch: bool = False):
        xx = torch.clamp(x, self.vmin, self.vmax) if self.clip else x
        idx = level_index(xx, self.levels, self.vmin, self.vmax)
        return decode_levels(idx, self.levels, self.vmin, self.vmax).to(x.dtype)

    def wire_bits_per_scalar(self) -> float:
        return float(wire_index_bits(self.levels))


@dataclasses.dataclass(frozen=True)
class RandD(Compressor):
    """Paper Definition 3: keep exactly d = round(fraction·n) coordinates
    of each message, uniformly at random."""

    fraction: float = 0.5
    stochastic: bool = True

    def compress_leaf(self, gen, x, batch: bool = False):
        rows = _rows(x, batch)
        d = max(1, int(round(self.fraction * rows.shape[1])))
        # exactly-d mask: rank i.i.d. uniforms, keep the d smallest
        u = torch.rand(rows.shape, generator=gen, device=x.device)
        kth = -torch.topk(-u, d, dim=1).values[:, d - 1:d]
        return torch.where(u <= kth, rows, 0).to(x.dtype).reshape(x.shape)

    def wire_bits_per_scalar(self) -> float:
        return 64.0 * self.fraction


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Keep the k = round(fraction·n) largest-|x| coordinates per message."""

    fraction: float = 0.1

    def compress_leaf(self, gen, x, batch: bool = False):
        rows = _rows(x, batch)
        k = max(1, int(round(self.fraction * rows.shape[1])))
        mag = rows.abs()
        kth = torch.topk(mag, k, dim=1).values[:, k - 1:k]
        return torch.where(mag >= kth, rows, 0).to(x.dtype).reshape(x.shape)

    def wire_bits_per_scalar(self) -> float:
        return 64.0 * self.fraction


@dataclasses.dataclass(frozen=True)
class ScaledSign(Compressor):
    """C(x) = (‖x‖₁/n)·sign(x), with ``sign(0) := +1`` so every output
    coordinate is exactly ±scale (1 bit/coordinate + one scale)."""

    def compress_leaf(self, gen, x, batch: bool = False):
        rows = _rows(x, batch)
        scale = rows.abs().mean(dim=1, keepdim=True)
        out = scale * torch.where(rows >= 0, 1.0, -1.0)
        return out.to(x.dtype).reshape(x.shape)

    def wire_bits_per_scalar(self) -> float:
        return 1.0


# ---------------------------------------------------------------------------
# On-wire integer codec.
# ---------------------------------------------------------------------------

def _int_dtype(levels: int):
    if levels <= 255:
        return torch.uint8
    if levels <= 65535:
        return torch.uint16
    return torch.uint32


#: values per piece of the quantizer's float64 arithmetic (``level_index``,
#: ``decode_levels``): a leaf of a full-width model with its agent axis
#: holds up to 5.5e8 values, 4.4 GB per float64 copy
PIECE = 2**25


def quantize_encode(x, levels: int, vmin: float, vmax: float):
    """Integer level indices, clamped to [0, L] (the bytes that cross the
    link); matches :class:`UniformQuantizer` with clip=True.  Computed a
    piece of ``PIECE`` values at a time."""
    out = torch.empty(x.shape, dtype=_int_dtype(levels), device=x.device)
    src, dst = x.reshape(-1), out.view(-1)
    for s in range(0, src.numel(), PIECE):
        idx = level_index(torch.clamp(src[s:s + PIECE], vmin, vmax), levels, vmin, vmax)
        idx = torch.clamp(idx, 0, levels)
        if levels > 2**31 - 1:
            dst[s:s + PIECE] = idx.to(torch.int64).to(torch.uint32)
        else:
            dst[s:s + PIECE] = idx.to(torch.int32).to(out.dtype)
    return out


def quantize_decode(idx, levels: int, vmin: float, vmax: float,
                    dtype=torch.float32):
    """Level indices (any integer dtype, uint32 included) back to floats,
    a piece of ``PIECE`` values at a time."""
    from ..kernels.ref import as_int64  # lazy: kernels import this module
    out = torch.empty(idx.shape, dtype=dtype, device=idx.device)
    src, dst = idx.reshape(-1), out.view(-1)
    for s in range(0, src.numel(), PIECE):
        dst[s:s + PIECE] = decode_levels(as_int64(src[s:s + PIECE]), levels, vmin, vmax)
    return out


def make_compressor(name: str, **kw) -> Compressor:
    """Build a compressor by name: identity, quant, rand_d, top_k, sign."""
    table = {
        "identity": Identity,
        "quant": UniformQuantizer,
        "rand_d": RandD,
        "top_k": TopK,
        "sign": ScaledSign,
    }
    if name not in table:
        raise ValueError(f"unknown compressor {name!r}; options: {sorted(table)}")
    return table[name](**kw)
