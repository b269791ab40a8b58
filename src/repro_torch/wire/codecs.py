"""Wire codecs: compressor output → exact on-wire bytes (paper §2.4).

=================  ========  =====================================  =============
compressor          codec     wire format                            bits/scalar
=================  ========  =====================================  =============
UniformQuantizer    quant     b-bit level indices bit-packed into    b = ⌈log₂(L+1)⌉
                              uint32 words
ScaledSign          sign      1 bit/coordinate + one f32 scale       1
TopK / RandD        sparse    k packed ⌈log₂ n⌉-bit indices +        (⌈log₂n⌉+8·itemsize)·k/n
                              k raw values
Identity            dense     raw little-endian floats               8·itemsize
=================  ========  =====================================  =============

Bit-packing runs through :mod:`repro_torch.kernels.ops` (the CUDA kernels
on the card).  Round trip: ``codec.decode(codec.encode(C(x))) == C(x)``
bit-exactly for the matching compressor (``clip=True`` for the quantizer).
Words packed here decode in the JAX package's codecs and the other way
round.  Integer indices and words pass through int32 views: torch has no
uint32 arithmetic on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.compression import (Compressor, Identity, RandD, ScaledSign, TopK,
                                UniformQuantizer, quantize_decode,
                                quantize_encode, wire_index_bits)
from ..core.pytree import tree_leaves, tree_map, tree_unflatten
from ..kernels import ops
from ..kernels.pack_bits import logical_words
from ..kernels.ref import as_int64
from .message import (MESSAGE_HEADER_NBYTES, LeafWire, WireMessage,
                      leaf_header_nbytes)


def index_bits(n: int) -> int:
    """Bits needed to address a coordinate in an n-vector."""
    return max(1, math.ceil(math.log2(max(n, 2))))


class WireCodec:
    """Base codec: per-leaf encode/decode + exact byte accounting."""

    kind: str = "?"
    HEADER_EXTRA_NBYTES: int = 0

    # -- per-leaf ---------------------------------------------------------
    def encode_leaf(self, x) -> LeafWire:  # pragma: no cover - abstract
        raise NotImplementedError

    def decode_leaf(self, lw: LeafWire):   # pragma: no cover - abstract
        raise NotImplementedError

    # -- exact accounting -------------------------------------------------
    def leaf_header_nbytes(self, ndim: int) -> int:
        return leaf_header_nbytes(ndim, self.HEADER_EXTRA_NBYTES)

    def leaf_payload_nbytes(self, n: int, itemsize: int = 4) -> int:
        raise NotImplementedError

    def leaf_nbytes(self, shape: Tuple[int, ...], itemsize: int = 4) -> int:
        return (self.leaf_header_nbytes(len(shape))
                + self.leaf_payload_nbytes(math.prod(shape), itemsize))

    def wire_bits_per_scalar_measured(self, n: int, itemsize: int = 4) -> float:
        """Exact bits/scalar of an n-vector leaf, headers included."""
        return 8.0 * self.leaf_nbytes((n,), itemsize) / n

    # -- tree -------------------------------------------------------------
    def encode(self, tree) -> WireMessage:
        return WireMessage([self.encode_leaf(x) for x in tree_leaves(tree)],
                           tree_map(lambda _: None, tree))

    def decode(self, msg: WireMessage):
        return tree_unflatten(msg.treedef,
                              [self.decode_leaf(lw) for lw in msg.leaves])

    def tree_nbytes(self, tree) -> int:
        """On-wire size of ``encode(tree)``, message header included."""
        return MESSAGE_HEADER_NBYTES + sum(
            self.leaf_nbytes(tuple(x.shape), x.element_size())
            for x in tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class QuantCodec(WireCodec):
    """b-bit packed level indices for :class:`UniformQuantizer`.

    Header extras: levels ``u32`` + vmin ``f32`` + vmax ``f32``.
    """

    levels: int = 255
    vmin: float = -1.0
    vmax: float = 1.0

    kind = "quant"
    HEADER_EXTRA_NBYTES = 12

    @property
    def bits(self) -> int:
        return wire_index_bits(self.levels)

    def encode_leaf(self, x) -> LeafWire:
        idx = quantize_encode(x, self.levels, self.vmin, self.vmax)
        words = ops.pack_bits(idx, self.bits)
        return LeafWire(self.kind, tuple(x.shape), x.dtype, {"words": words},
                        self.leaf_header_nbytes(x.ndim),
                        self.leaf_payload_nbytes(x.numel()),
                        meta={"bits": self.bits})

    def decode_leaf(self, lw: LeafWire):
        idx = ops.unpack_bits(lw.payload["words"], self.bits, math.prod(lw.shape))
        return quantize_decode(idx, self.levels, self.vmin, self.vmax,
                               torch.float32).to(lw.dtype).reshape(lw.shape)

    def leaf_payload_nbytes(self, n: int, itemsize: int = 4) -> int:
        return 4 * logical_words(n, self.bits)


@dataclasses.dataclass(frozen=True)
class SignCodec(WireCodec):
    """1-bit sign packing for :class:`ScaledSign` (+ one f32 scale).

    Header extras: scale ``f32``.  The bit is ``x > 0``, so every
    coordinate of a :class:`ScaledSign` output (exactly ±scale) round-trips;
    an all-zero leaf decodes to −0.0, as in the JAX package.
    """

    kind = "sign"
    HEADER_EXTRA_NBYTES = 4

    def encode_leaf(self, x) -> LeafWire:
        flat = x.reshape(-1)
        scale = flat.abs().max().to(torch.float32)
        words = ops.pack_bits((flat > 0).to(torch.int32), 1)
        return LeafWire(self.kind, tuple(x.shape), x.dtype,
                        {"words": words, "scale": scale},
                        self.leaf_header_nbytes(x.ndim),
                        self.leaf_payload_nbytes(x.numel()),
                        meta={"bits": 1})

    def decode_leaf(self, lw: LeafWire):
        bit = as_int64(ops.unpack_bits(lw.payload["words"], 1,
                                       math.prod(lw.shape)))
        s = lw.payload["scale"]
        return torch.where(bit == 1, s, -s).to(lw.dtype).reshape(lw.shape)

    def leaf_payload_nbytes(self, n: int, itemsize: int = 4) -> int:
        return 4 * logical_words(n, 1)


@dataclasses.dataclass(frozen=True)
class SparseCodec(WireCodec):
    """Index+value packing for :class:`TopK` / :class:`RandD` outputs.

    The indices of the nonzero coordinates are bit-packed at
    ``index_bits(n)`` bits; the values ride raw in the leaf dtype.
    ``encode`` counts the actual nonzeros (read on the host), so the
    accounted bytes are what a transmitter would send; ties in TopK or
    zero-valued kept coordinates in RandD shrink the payload below the
    nominal ``fraction·n``.  An all-zero leaf (k = 0) carries one tile of
    zero words and no value, as in the JAX package.

    Header extras: k ``u32``.
    """

    fraction: float = 0.1

    kind = "sparse"
    HEADER_EXTRA_NBYTES = 4

    def encode_leaf(self, x) -> LeafWire:
        flat = x.reshape(-1)
        n = flat.numel()
        nz = torch.nonzero(flat).reshape(-1)
        k = nz.numel()
        bits = index_bits(n)
        words = ops.pack_bits(nz.to(torch.int32), bits)
        payload_nbytes = 4 * logical_words(k, bits) + k * x.element_size()
        return LeafWire(self.kind, tuple(x.shape), x.dtype,
                        {"words": words, "values": flat[nz]},
                        self.leaf_header_nbytes(x.ndim), payload_nbytes,
                        meta={"bits": bits, "k": k})

    def decode_leaf(self, lw: LeafWire):
        idx = ops.unpack_bits(lw.payload["words"], lw.meta["bits"],
                              lw.meta["k"])
        values = lw.payload["values"]
        out = torch.zeros(math.prod(lw.shape), dtype=lw.dtype,
                          device=values.device)
        out[as_int64(idx)] = values
        return out.reshape(lw.shape)

    def leaf_payload_nbytes(self, n: int, itemsize: int = 4) -> int:
        k = max(1, int(round(self.fraction * n)))
        return 4 * logical_words(k, index_bits(n)) + k * itemsize


@dataclasses.dataclass(frozen=True)
class DenseCodec(WireCodec):
    """Raw float serialization for :class:`Identity` (no compression)."""

    kind = "dense"
    HEADER_EXTRA_NBYTES = 0

    def encode_leaf(self, x) -> LeafWire:
        return LeafWire(self.kind, tuple(x.shape), x.dtype,
                        {"raw": x.reshape(-1)},
                        self.leaf_header_nbytes(x.ndim),
                        self.leaf_payload_nbytes(x.numel(), x.element_size()))

    def decode_leaf(self, lw: LeafWire):
        return lw.payload["raw"].reshape(lw.shape)

    def leaf_payload_nbytes(self, n: int, itemsize: int = 4) -> int:
        return n * itemsize


def codec_for(compressor: Compressor) -> Optional[WireCodec]:
    """The wire codec matching a compressor (None if it has no codec)."""
    if isinstance(compressor, UniformQuantizer):
        return QuantCodec(compressor.levels, compressor.vmin, compressor.vmax)
    if isinstance(compressor, ScaledSign):
        return SignCodec()
    if isinstance(compressor, (TopK, RandD)):
        return SparseCodec(compressor.fraction)
    if isinstance(compressor, Identity):
        return DenseCodec()
    return None


def measure_tree_bytes(compressor: Compressor, tree) -> float:
    """Measured on-wire bytes of one message: encode ``tree`` through the
    compressor's codec and count.  Falls back to the nominal
    ``wire_bits_per_scalar`` estimate for compressors without a codec."""
    codec = codec_for(compressor)
    if codec is None:
        n = sum(x.numel() for x in tree_leaves(tree))
        return n * compressor.wire_bits_per_scalar() / 8.0
    return float(codec.encode(tree).nbytes)
