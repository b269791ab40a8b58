"""Warmup/timing utilities shared by the registered benchmarks.

Counterpart of ``repro.bench.timing`` with the same estimators: the
least of ``reps`` timed calls, A/B pairs timed in turns, and the cyclic
garbage collector held out of the timed window.

The clock is the host's wall clock, ended by a wait on the card: a call
that returns a CUDA tensor (in a tuple, list or dict too) is followed by
``torch.cuda.synchronize()`` inside the window, as the JAX package waits
with ``jax.block_until_ready``.  Before each window opens, whatever an
earlier call left queued on the card is drained, so it is not timed.

Timed regions run with the cyclic garbage collector DISABLED (after one
up-front ``gc.collect()``): dispatch-heavy benchmark bodies allocate
thousands of small host objects, and whether a GC generation threshold
happens to trip inside the timed region depends on how much heap the
*previously run* benchmarks left behind — which made gated ratios depend
on registry order and on full-vs-tiny runs.  Pinning GC out of the timed
window removes that coupling; the collector is restored (and run once)
afterwards.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable

import torch

from ..device import block_until_ready as _block


def _drain() -> None:
    """Wait for work already queued on the card (none if CUDA was never
    initialized in this process)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def _gc_pinned():
    """Collect once, then keep the cyclic GC out of the timed region."""
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
            gc.collect()


def time_fn(fn: Callable, *, reps: int = 5, warmup: int = 1) -> float:
    """Seconds per call of ``fn()``: ``warmup`` untimed calls (kernel
    build, cache fill), then the MINIMUM of ``reps`` timed calls — the
    robust estimator of the achievable time on a noisy shared machine —
    waiting on the returned value so the card's queued work doesn't leak
    out of the clock."""
    for _ in range(warmup):
        _block(fn())
    best = float("inf")
    with _gc_pinned():
        for _ in range(max(reps, 1)):
            _drain()
            t0 = time.perf_counter()
            _block(fn())
            best = min(best, time.perf_counter() - t0)
    return best


def time_pair(fn_a: Callable, fn_b: Callable, *, reps: int = 7,
              warmup: int = 1) -> tuple:
    """Interleaved min-of-``reps`` timing of two functions.

    Alternating A/B measurements make background load spikes hit both
    paths symmetrically, which stabilizes the A/B *ratio* (the quantity
    perf gates enforce) far better than timing each phase separately.
    Returns (seconds_a, seconds_b).
    """
    for _ in range(warmup):
        _block(fn_a())
        _block(fn_b())
    best_a = best_b = float("inf")
    with _gc_pinned():
        for _ in range(max(reps, 1)):
            _drain()
            t0 = time.perf_counter()
            _block(fn_a())
            best_a = min(best_a, time.perf_counter() - t0)
            _drain()
            t0 = time.perf_counter()
            _block(fn_b())
            best_b = min(best_b, time.perf_counter() - t0)
    return best_a, best_b


def gbps(nbytes: float, seconds: float) -> float:
    """Throughput in GB/s (1e9 bytes)."""
    return nbytes / max(seconds, 1e-12) / 1e9
