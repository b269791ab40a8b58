"""The constellation's cohort uplink transport on the card.

Counterpart of the device half of ``benchmarks/sim_scale.py``: the port's
engine produces a few sync rounds of deliveries, then every delivered
update is serialized on the card through one of two chains:

* **fused**, one ``quant_pipeline`` launch per contact-window cohort over
  the cohort's stacked updates (and, on a lossy channel, one
  ``erasure_mask`` launch over the cohort's words);
* **unfused**, the historical per-satellite chain: ``quantize_ef`` then
  ``pack_bits(wire, 8)`` for each delivered satellite (and one
  ``erasure_mask`` each on a lossy channel).

:func:`round_pipeline` (``mega-1000``, lossless) and :func:`lossy_round`
(``mega-1000-lossy``) time the engine with ``perf_counter`` and each chain
with CUDA events, and return the timings, the counts of cohorts and
deliveries, and the last words of each chain.  Each update is ``DIM``
float32 values quantized at ``LEVELS`` levels over ``[VMIN, VMAX]``.

The chains take a ``kern`` namespace of four functions; the default is
:mod:`repro_torch.kernels.ops` (kernels on the card, plain versions on
the CPU) and :data:`PLAIN` runs the plain versions on any device, which
is what a caller holds the kernels against.
"""
from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from ..channel import ChannelModel, SelectiveRepeatARQ
from ..constellation.links import message_bytes
from ..constellation.orbits import GroundStation, Walker
from ..device import resolve_device
from ..kernels import ops, ref
from ..sim import Engine, Scenario, get_scenario

MSG = message_bytes(10000, 10.0)

# uplink payload per satellite: DIM float32 values quantized to an 8-bit
# wire (255 levels over ±1)
DIM = 2048
LEVELS, VMIN, VMAX = 255, -1.0, 1.0
WIRE_BITS = 8
P_LOSS = 0.1

#: the four chain functions through their plain versions
PLAIN = types.SimpleNamespace(quant_pipeline=ref.quant_pipeline_ref,
                              quantize_ef=ref.quantize_ef_ref,
                              pack_bits=ref.pack_bits_ref,
                              erasure_mask=ref.erasure_mask_ref)


def scenarios(n_sats: int, p_loss: float = P_LOSS):
    """(lossless, lossy) scenarios at ``n_sats``: ``mega-1000`` and
    ``mega-1000-lossy`` from 1000 satellites on, else a Walker of
    ``n_sats`` over one station with a flat ``p_loss`` channel."""
    if n_sats >= 1000:
        return get_scenario("mega-1000"), get_scenario("mega-1000-lossy")
    clean = Scenario(name=f"scale-{n_sats}",
                     walker=Walker(n_sats=n_sats,
                                   n_planes=max(2, n_sats // 10)),
                     stations=(GroundStation(),))
    lossy = Scenario(name=f"scale-{n_sats}-lossy", walker=clean.walker,
                     stations=clean.stations,
                     channel=ChannelModel(loss=p_loss,
                                          arq=SelectiveRepeatARQ(max_rounds=4)))
    return clean, lossy


def engine_rounds(eng: Engine, rounds: int) -> list:
    """``rounds`` sync rounds from t=0, each at the message size ``MSG``."""
    t, out = 0.0, []
    for _ in range(rounds):
        res = eng.run_round(t, MSG)
        t += res.duration
        out.append(res)
    return out


def updates(n_sats: int, seed: int, device) -> torch.Tensor:
    """The (n_sats, DIM) float32 updates the chains serialize."""
    vals = np.random.default_rng(seed).normal(
        0.0, 0.3, (n_sats, DIM)).astype(np.float32)
    return torch.from_numpy(vals).to(device)


def chain_counts(results) -> dict:
    """Cohorts and deliveries (attempted uplinks) over ``results``."""
    return {"cohorts": sum(len(r.cohorts()) for r in results),
            "deliveries": sum(len(r.deliveries) for r in results)}


# -- the chains -------------------------------------------------------------

def uplink_unfused(vals, results, kern=ops):
    """One quantize_ef and one pack_bits per delivered satellite."""
    zeros = torch.zeros(DIM, dtype=torch.float32, device=vals.device)
    out = None
    for res in results:
        for d in res.deliveries:
            wire, _ = kern.quantize_ef(vals[d.sat], zeros, levels=LEVELS,
                                       vmin=VMIN, vmax=VMAX)
            out = kern.pack_bits(wire, WIRE_BITS)
    return out


def uplink_fused(vals, results, kern=ops):
    """One quant_pipeline per contact-window cohort, over the cohort's
    stacked updates."""
    out = None
    for res in results:
        for cohort in res.cohorts():
            stack = vals[torch.as_tensor(cohort.sats, device=vals.device)]
            out, _ = kern.quant_pipeline(stack, torch.zeros_like(stack),
                                         levels=LEVELS, vmin=VMIN, vmax=VMAX)
    return out


def lossy_unfused(vals, results, p: float, seed: int, kern=ops):
    """quantize_ef → pack_bits → erasure_mask per delivered satellite."""
    zeros = torch.zeros(DIM, dtype=torch.float32, device=vals.device)
    out = None
    for res in results:
        for d in res.deliveries:
            wire, _ = kern.quantize_ef(vals[d.sat], zeros, levels=LEVELS,
                                       vmin=VMIN, vmax=VMAX)
            words = kern.pack_bits(wire, WIRE_BITS)
            out, _ = kern.erasure_mask(words, p=p, seed=seed)
    return out


def lossy_fused(vals, results, p: float, seed: int, kern=ops):
    """quant_pipeline → erasure_mask per contact-window cohort."""
    out = None
    for res in results:
        for cohort in res.cohorts():
            stack = vals[torch.as_tensor(cohort.sats, device=vals.device)]
            words, _ = kern.quant_pipeline(stack, torch.zeros_like(stack),
                                           levels=LEVELS, vmin=VMIN,
                                           vmax=VMAX)
            out, _ = kern.erasure_mask(words, p=p, seed=seed)
    return out


def decoded_agree(vals, results) -> tuple:
    """Per delivered satellite, the fused chain's decoded indices against
    the unfused chain's wire: returns ``(satellites checked, mismatches)``."""
    zeros = torch.zeros(DIM, dtype=torch.float32, device=vals.device)
    checked = bad = 0
    for res in results:
        for cohort in res.cohorts():
            stack = vals[torch.as_tensor(cohort.sats, device=vals.device)]
            words, _ = ops.quant_pipeline(stack, torch.zeros_like(stack),
                                          levels=LEVELS, vmin=VMIN, vmax=VMAX)
            idx = ops.unpack_bits(words, WIRE_BITS, stack.numel())
            idx = ref.as_int64(idx).reshape(stack.shape)
            for row, s in enumerate(cohort.sats):
                wire, _ = ops.quantize_ef(vals[s], zeros, levels=LEVELS,
                                          vmin=VMIN, vmax=VMAX)
                checked += 1
                bad += not torch.equal(idx[row], ref.as_int64(wire))
    return checked, bad


# -- timing -----------------------------------------------------------------

def _host_s(fn, reps: int) -> float:
    """Least host seconds of ``reps`` calls, the cyclic GC held off."""
    gc.collect()
    gc.disable()
    try:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    finally:
        gc.enable()


def _device_ms(fn, device) -> float:
    """Milliseconds of one call of ``fn``: CUDA events on the card; on the
    CPU the host clock (a CPU number, not a device time)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _time_chains(unfused, fused, device, reps: int):
    """One warm pass of each chain, then ``reps`` interleaved timed pairs
    (unfused, fused, fused, unfused, …); least ms of each, and the last
    words of each."""
    out_u, out_f = unfused(), fused()
    ms_u, ms_f = [], []
    for r in range(reps):
        pair = ((unfused, ms_u), (fused, ms_f))
        for fn, acc in (pair if r % 2 == 0 else pair[::-1]):
            acc.append(_device_ms(fn, device))
    return min(ms_u), min(ms_f), out_u, out_f


def round_pipeline(n_sats: int = 1000, rounds: int = 3, seed: int = 0,
                   device=None, reps: int = 3) -> dict:
    """Lossless sync rounds with uplink serialization, fused vs unfused.

    The engine runs ``rounds`` once to build its contact plan and the
    delivery trajectory; the engine pass is then timed on the host clock
    and each chain on the device (``1 + reps`` passes of each).  Runs on
    the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    sc, _ = scenarios(n_sats)
    eng = Engine(sc, seed=seed)
    results = engine_rounds(eng, rounds)
    engine_s = _host_s(lambda: engine_rounds(eng, rounds), reps)
    vals = updates(sc.walker.n_sats, seed, dev)
    ms_u, ms_f, out_u, out_f = _time_chains(
        lambda: uplink_unfused(vals, results),
        lambda: uplink_fused(vals, results), dev, reps)
    return {"scenario": sc.name, "n_sats": sc.walker.n_sats, "rounds": rounds,
            **chain_counts(results), "passes": 1 + reps,
            "device": str(dev),
            "engine_ms_per_round": 1e3 * engine_s / rounds,
            "uplink_ms_unfused": ms_u / rounds,
            "uplink_ms_fused": ms_f / rounds,
            "uplink_speedup": ms_u / ms_f,
            "words_unfused": out_u, "words_fused": out_f,
            "results": results, "vals": vals}


def lossy_round(n_sats: int = 1000, rounds: int = 3, seed: int = 0,
                p_loss: float = P_LOSS, device=None, reps: int = 3) -> dict:
    """Lossy-channel round cost and the lossy uplink transport on the card.

    The engine is timed on ``mega-1000`` and ``mega-1000-lossy`` (channel
    overhead, host clock); then, over the lossy trajectory, the fused
    ``quant_pipeline → erasure_mask`` chain against the unfused
    ``quantize_ef → pack_bits → erasure_mask`` chain (device time).  Runs
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    sc_clean, sc_lossy = scenarios(n_sats, p_loss)
    eng_clean = Engine(sc_clean, seed=seed)
    eng_lossy = Engine(sc_lossy, seed=seed)
    results = engine_rounds(eng_lossy, rounds)
    engine_rounds(eng_clean, rounds)
    clean_s = _host_s(lambda: engine_rounds(eng_clean, rounds), reps)
    lossy_s = _host_s(lambda: engine_rounds(eng_lossy, rounds), reps)
    vals = updates(sc_lossy.walker.n_sats, seed, dev)
    ms_u, ms_f, out_u, out_f = _time_chains(
        lambda: lossy_unfused(vals, results, p_loss, seed),
        lambda: lossy_fused(vals, results, p_loss, seed), dev, reps)
    lost = sum(sum(not d.delivered for d in r.deliveries) for r in results)
    return {"scenario": sc_lossy.name, "n_sats": sc_lossy.walker.n_sats,
            "rounds": rounds, **chain_counts(results), "passes": 1 + reps,
            "device": str(dev), "lost": lost,
            "retransmissions": sum(sum(d.retries for d in r.deliveries)
                                   for r in results),
            "engine_ms_per_round_lossless": 1e3 * clean_s / rounds,
            "engine_ms_per_round": 1e3 * lossy_s / rounds,
            "channel_overhead": lossy_s / clean_s,
            "uplink_ms_unfused": ms_u / rounds,
            "uplink_ms_fused": ms_f / rounds,
            "lossy_uplink_speedup": ms_u / ms_f,
            "words_unfused": out_u, "words_fused": out_f,
            "results": results, "vals": vals, "p_loss": p_loss,
            "seed": seed}
