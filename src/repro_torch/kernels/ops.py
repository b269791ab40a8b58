"""Dispatchers for the port's kernels.

Each runs under ``torch.profiler.record_function("repro.kernels.<name>")``
so it shows up named in a profiler trace, and goes to the CUDA kernel for
a tensor on the card and to the plain version for a tensor on the CPU.
The kernels count their own launches (:data:`._build.launches`); read
them with :func:`launch_counts` and zero them with
:func:`reset_launch_counts`.
"""
from __future__ import annotations

import functools

from torch.profiler import record_function

from . import _build
from .compress_pipeline import quant_pipeline as _quant_pipeline
from .pack_bits import pack_bits as _pack_bits
from .pack_bits import unpack_bits as _unpack_bits


def _annotated(fn):
    label = f"repro.kernels.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return wrapper


@_annotated
def pack_bits(x, bits: int):
    """Pack b-bit values into uint32 wire words."""
    return _pack_bits(x, bits)


@_annotated
def unpack_bits(words, bits: int, n: int):
    """Inverse of :func:`pack_bits`: first ``n`` values, flat uint32."""
    return _unpack_bits(words, bits, n)


@_annotated
def quant_pipeline(msg, cache, *, levels=255, vmin=-1.0, vmax=1.0):
    """Fused quantize→EF→pack sweep: (msg, cache) → (wire words, new cache)."""
    return _quant_pipeline(msg, cache, levels=levels, vmin=vmin, vmax=vmax)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return dict(_build.launches)


def reset_launch_counts() -> None:
    _build.reset_launches()
