"""Dispatchers for the port's kernels.

Each goes to the CUDA kernel for a tensor on the card and to the plain
version for a tensor on the CPU, and runs under
``torch.profiler.record_function("repro.kernels.<name>")`` so it shows
up named in a profiler trace.  With an active :mod:`repro_torch.obs`
tracer each call also records a host-side ``kernel`` record and a
``kernel.<name>`` phase, as the JAX package's dispatchers do, and, when
the tracer's meta sets ``prof_sync``, a ``kernel.<name>[device]`` record
and phase timed around ``torch.cuda.synchronize()`` (the device's share;
~0 for a CPU tensor, where nothing is queued); disabled, that costs one
module attribute read and a ``None`` check.  The kernels
count their own launches (:data:`._build.launches`); read them with
:func:`launch_counts` and zero them with :func:`reset_launch_counts`.
"""
from __future__ import annotations

import functools
import time

from torch.profiler import record_function

from ..device import block_until_ready
from ..obs.trace import active as _obs_active
from . import _build
from .compress_pipeline import quant_pipeline as _quant_pipeline
from .compress_pipeline import sign_pipeline as _sign_pipeline
from .erasure_mask import erasure_mask as _erasure_mask
from .flash_attention import flash_attention as _flash_attention
from .pack_bits import pack_bits as _pack_bits
from .pack_bits import unpack_bits as _unpack_bits
from .quantize_ef import quantize_ef as _quantize_ef


def _annotated(fn):
    name = fn.__name__
    label = f"repro.kernels.{name}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        trc = _obs_active()
        if trc is None:
            with record_function(label):
                return fn(*args, **kwargs)
        with record_function(label):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dur = time.perf_counter() - t0
        trc.raw({"kind": "kernel", "name": name,
                 "t_host": t0 - trc._t0_host, "dur_host": dur})
        trc.prof.add("kernel." + name, dur)
        if trc.prof.sync_device:
            # the dispatch above times the host's launch only; this wait
            # (opt-in, prof_sync meta) is the device's share
            t1 = time.perf_counter()
            block_until_ready(out)
            dur_sync = time.perf_counter() - t1
            trc.raw({"kind": "kernel", "name": name + "[device]",
                     "t_host": t1 - trc._t0_host, "dur_host": dur_sync})
            trc.prof.add("kernel." + name + "[device]", dur_sync)
        trc.metrics.counter("kernel_dispatches").add(1.0, name=name)
        return out

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


@_annotated
def sign_pipeline(msg, cache):
    """Fused scaled-sign→EF→1-bit-pack sweep → (words, scale, new cache)."""
    return _sign_pipeline(msg, cache)


@_annotated
def quantize_ef(msg, cache, *, levels=255, vmin=-0.25, vmax=0.25):
    """Fused quantize + EF: (msg, cache) → (uint8/uint16 wire, new cache)."""
    return _quantize_ef(msg, cache, levels=levels, vmin=vmin, vmax=vmax)


@_annotated
def erasure_mask(words, *, p: float, seed: int = 0, segment_words: int = 32):
    """Counter-hash segment erasure over packed words → (masked, keep)."""
    return _erasure_mask(words, p=p, seed=seed, segment_words=segment_words)


@_annotated
def attention(q, k, v, *, causal=True, window=None, softcap=None, q_pos=None,
              k_pos=None):
    """(B, S, H, D) attention over k/v (B, S, Hkv, D), H % Hkv == 0;
    positions default to ``arange`` (the Pallas kernel's function)."""
    return _flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, softcap=softcap)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return dict(_build.launches)


def reset_launch_counts() -> None:
    _build.reset_launches()
