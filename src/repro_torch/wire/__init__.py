"""Wire codecs: real serialization for compressed updates.

``codec_for(compressor)`` returns a :class:`~repro_torch.wire.codecs.WireCodec`
whose ``encode`` turns a compressor output tree into a
:class:`~repro_torch.wire.message.WireMessage` (packed uint32 words and
exact header/payload byte counts, through the port's pack kernels) and
whose ``decode`` restores it bit for bit.  The simulator derives its
transmission times and ``bytes_up`` accounting from ``WireMessage.nbytes``.
"""
from .codecs import (DenseCodec, QuantCodec, SignCodec, SparseCodec,
                     WireCodec, codec_for, index_bits, measure_tree_bytes)
from .message import (LEAF_HEADER_BASE_NBYTES, MESSAGE_HEADER_NBYTES,
                      SHAPE_DIM_NBYTES, LeafWire, WireMessage)

__all__ = [
    "WireCodec", "QuantCodec", "SignCodec", "SparseCodec", "DenseCodec",
    "codec_for", "measure_tree_bytes", "index_bits",
    "WireMessage", "LeafWire", "MESSAGE_HEADER_NBYTES",
    "LEAF_HEADER_BASE_NBYTES", "SHAPE_DIM_NBYTES",
]
