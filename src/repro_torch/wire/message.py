"""On-wire message container with exact byte accounting (paper §2.4).

A :class:`WireMessage` is what a satellite transmits: a fixed-size message
header, one header per tree leaf, and the packed payload tensors.
``nbytes`` is the canonical on-wire size.

Byte-accounting convention (the JAX package's, unchanged):

* **Message header** (:data:`MESSAGE_HEADER_NBYTES` = 8): magic ``u16``,
  version ``u8``, leaf count ``u8``, total payload length ``u32``.
* **Leaf header**: 4 bytes base (kind ``u8``, ndim ``u8``, bit width
  ``u8``, dtype code ``u8``) + 4 bytes (``u32``) per shape dim + the
  codec's extra fields (``HEADER_EXTRA_NBYTES``).
* **Payload**: exact packed size.  Bit-packed streams count
  ``4·b·ceil(n/32)`` bytes; the tile padding of the word buffers is
  memory layout only and never counted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

MESSAGE_HEADER_NBYTES = 8
LEAF_HEADER_BASE_NBYTES = 4
SHAPE_DIM_NBYTES = 4


@dataclasses.dataclass
class LeafWire:
    """One encoded tree leaf: packed payload + exact byte counts."""

    kind: str                       # codec tag: quant | sign | sparse | dense
    shape: Tuple[int, ...]          # original leaf shape
    dtype: Any                      # original leaf dtype
    payload: Dict[str, Any]         # packed tensors (may be tile-padded)
    header_nbytes: int              # exact leaf header size
    payload_nbytes: int             # exact logical payload size
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return self.header_nbytes + self.payload_nbytes


@dataclasses.dataclass
class WireMessage:
    """A fully encoded tree: ``decode`` restores the compressor output.

    ``treedef`` is the encoded tree with ``None`` at every leaf; decoding
    fills it back in leaf order.
    """

    leaves: List[LeafWire]
    treedef: Any

    @property
    def header_nbytes(self) -> int:
        return MESSAGE_HEADER_NBYTES + sum(l.header_nbytes for l in self.leaves)

    @property
    def payload_nbytes(self) -> int:
        return sum(l.payload_nbytes for l in self.leaves)

    @property
    def nbytes(self) -> int:
        """Exact on-wire size in bytes (headers + packed payloads)."""
        return MESSAGE_HEADER_NBYTES + sum(l.nbytes for l in self.leaves)


def leaf_header_nbytes(ndim: int, extra: int) -> int:
    """Exact leaf header size for a codec with ``extra`` header bytes."""
    return LEAF_HEADER_BASE_NBYTES + SHAPE_DIM_NBYTES * ndim + extra
