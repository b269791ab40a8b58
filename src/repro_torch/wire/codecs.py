"""Wire codecs: compressor output → exact on-wire bytes (paper §2.4).

=================  ========  =====================================  =============
compressor          codec     wire format                            bits/scalar
=================  ========  =====================================  =============
UniformQuantizer    quant     b-bit level indices bit-packed into    b = ⌈log₂(L+1)⌉
                              uint32 words
Identity            dense     raw little-endian floats               8·itemsize
=================  ========  =====================================  =============

Bit-packing runs through :mod:`repro_torch.kernels.ops` (the CUDA kernels
on the card).  Round trip: ``codec.decode(codec.encode(C(x))) == C(x)``
bit-exactly for the matching compressor (``clip=True`` for the quantizer).
The sign and sparse codecs of the JAX package are not ported yet;
:func:`codec_for` raises for their compressors.
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
from .message import (MESSAGE_HEADER_NBYTES, LeafWire, WireMessage,
                      leaf_header_nbytes)


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
    if isinstance(compressor, Identity):
        return DenseCodec()
    if isinstance(compressor, (ScaledSign, TopK, RandD)):
        raise NotImplementedError(
            f"the wire codec for {type(compressor).__name__} (sign/sparse) is "
            "not ported yet")
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
