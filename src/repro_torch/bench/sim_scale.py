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

The rest of ``benchmarks/sim_scale.py``'s public functions, under its
names and with its keys, are what the :mod:`repro_torch.bench` registry
wraps:

* :func:`bench_seed_path` / :func:`bench_plan_path`: the seed scheduler
  (a 720-step visibility grid re-propagated on every ``select``) against
  the precomputed contact plan;
* :func:`bench_scale`: engine throughput (cold plan build, sync rounds,
  async deliveries) up to ``mega-10000``;
* :func:`bench_round_pipeline` / :func:`bench_lossy_round`: the
  reference's keys over :func:`round_pipeline` / :func:`lossy_round`, a
  round's seconds being the engine's host seconds plus the chain's device
  seconds;
* :func:`bench_fast_round`: the fast engine against the heapq oracle,
  equivalence asserted first;
* :func:`bench_trace_overhead`: tracing on against off, < 1.05 asserted
  from 1000 satellites on.

Run:  PYTHONPATH=src python -m repro_torch.bench.sim_scale [--quick]
      [--rounds N] [--seed S]

prints ``sim_scale,us,speedup=…,sats1000_ok=…`` as the reference does.
The engine is host code; the chains run on the card unless
``device="cpu"``.
"""
from __future__ import annotations

import argparse
import gc
import time
import types

import numpy as np
import torch

from ..channel import ChannelModel, SelectiveRepeatARQ
from ..constellation.links import LinkModel, message_bytes
from ..constellation.orbits import GroundStation, Walker
from ..constellation.scheduler import Scheduler, legacy_select
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


def _scenario(n_sats: int) -> Scenario:
    """``mega-10000`` from 10000 satellites on, ``mega-1000`` from 1000,
    else a Walker of ``n_sats`` in ``n_sats // 10`` planes over one
    station."""
    if n_sats >= 10000:
        return get_scenario("mega-10000")
    if n_sats >= 1000:
        return get_scenario("mega-1000")
    return Scenario(name=f"scale-{n_sats}",
                    walker=Walker(n_sats=n_sats,
                                  n_planes=max(2, n_sats // 10)),
                    stations=(GroundStation(),))


def scenarios(n_sats: int, p_loss: float = P_LOSS):
    """(lossless, lossy) scenarios at ``n_sats``: ``mega-1000`` and
    ``mega-1000-lossy`` from 1000 satellites on, else :func:`_scenario`
    and the same Walker with a flat ``p_loss`` channel."""
    if n_sats >= 1000:
        return get_scenario("mega-1000"), get_scenario("mega-1000-lossy")
    clean = _scenario(n_sats)
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
    sc = _scenario(n_sats)
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


# -- the reference's benchmarks ---------------------------------------------

def bench_seed_path(rounds: int, walker: Walker, gs: GroundStation,
                    link: LinkModel) -> float:
    """Seconds of ``rounds`` rounds of the seed scheduler."""
    t0 = time.perf_counter()
    t = 0.0
    for _ in range(rounds):
        _, d = legacy_select(walker, gs, link, t, MSG)
        t += d
    return time.perf_counter() - t0


def bench_plan_path(rounds: int, walker: Walker, gs: GroundStation) -> float:
    """Seconds of ``rounds`` rounds of the contact-plan scheduler, its
    plan built lazily inside the timed region."""
    sched = Scheduler(walker, gs)
    t0 = time.perf_counter()
    t = 0.0
    for _ in range(rounds):
        _, d = sched.select(t, MSG)
        t += d
    return time.perf_counter() - t0


def bench_scale(n_sats: int, rounds: int, async_deliveries: int) -> dict:
    """Cold engine: ``rounds`` sync rounds (plan build included), then
    ``async_deliveries`` async deliveries, each timed on the host."""
    eng = Engine(_scenario(n_sats))
    t0 = time.perf_counter()
    t, active = 0.0, 0
    for _ in range(rounds):
        res = eng.run_round(t, MSG)
        t += res.duration
        active += int(res.mask.sum())
    t_sync = time.perf_counter() - t0
    t0 = time.perf_counter()
    deliveries = eng.run_async(0.0, MSG, n_deliveries=async_deliveries)
    t_async = time.perf_counter() - t0
    return {"n_sats": n_sats, "sync_s": t_sync, "sync_active": active,
            "async_s": t_async, "async_n": len(deliveries)}


def bench_round_pipeline(n_sats: int, rounds: int = 3, seed: int = 0,
                         device=None) -> dict:
    """End-to-end sync rounds with uplink serialization, fused vs
    unfused, under the reference's keys: a round is the engine's host
    seconds plus the chain's device seconds (:func:`round_pipeline`, 9
    timed passes of each).  Chains on the card unless ``device="cpu"``."""
    r = round_pipeline(n_sats, rounds=rounds, seed=seed, device=device,
                       reps=9)
    engine_s = r["engine_ms_per_round"] / 1e3
    round_unfused = engine_s + r["uplink_ms_unfused"] / 1e3
    round_fused = engine_s + r["uplink_ms_fused"] / 1e3
    return {
        "n_sats": n_sats, "rounds": rounds, "deliveries": r["deliveries"],
        "engine_s_per_round": engine_s,
        "round_s_unfused": round_unfused,
        "round_s_fused": round_fused,
        "speedup": round_unfused / round_fused,
        "sats_per_sec_fused": r["deliveries"] / (rounds * round_fused),
    }


def bench_lossy_round(n_sats: int = 1000, rounds: int = 3, seed: int = 0,
                      p_loss: float = P_LOSS, device=None) -> dict:
    """Lossy-channel round cost and the lossy uplink transport under the
    reference's keys (:func:`lossy_round`, 9 timed passes): the engine's
    host seconds per round without and with the channel, and the fused
    ``quant_pipeline → erasure_mask`` chain's device seconds against the
    unfused ``quantize_ef → pack_bits → erasure_mask`` chain's.  From
    1000 satellites on, a trajectory that lost no update fails."""
    r = lossy_round(n_sats, rounds=rounds, seed=seed, p_loss=p_loss,
                    device=device, reps=9)
    if n_sats >= 1000 and r["lost"] == 0:
        raise AssertionError(
            f"mega-1000-lossy produced no lost deliveries over {rounds} "
            f"rounds — loss/ARQ tuning regressed "
            f"(attempted={r['deliveries']})")
    return {
        "n_sats": r["n_sats"], "rounds": rounds,
        "attempted": r["deliveries"], "lost": r["lost"],
        "retransmissions": r["retransmissions"],
        "round_s_lossless": r["engine_ms_per_round_lossless"] / 1e3,
        "round_s_lossy": r["engine_ms_per_round"] / 1e3,
        "channel_overhead": r["channel_overhead"],
        "uplink_s_unfused": r["uplink_ms_unfused"] / 1e3,
        "uplink_s_fused": r["uplink_ms_fused"] / 1e3,
        "lossy_uplink_speedup": r["lossy_uplink_speedup"],
    }


def bench_fast_round(n_sats: int, rounds: int = 3, seed: int = 0,
                     async_deliveries: int = 100) -> dict:
    """Fast batch-event core vs the heapq oracle on the SAME scenario.

    Equivalence first, speed second: before timing anything the two
    engines run the full sync trajectory and an async delivery stream and
    every ``Delivery`` record is compared field-for-field — a mismatch
    raises.  Timings are warm (plans built, caches populated), so the
    ratio isolates the event core + channel stack.
    """
    from .common import assert_fast_oracle_equivalent
    from .timing import time_pair

    sc = _scenario(n_sats)
    eng_fast = Engine(sc, seed=seed, fast=True)
    eng_oracle = Engine(_scenario(n_sats), seed=seed, fast=False)
    res_f = assert_fast_oracle_equivalent(       # warm + verify
        eng_fast, eng_oracle, MSG, rounds=rounds,
        async_deliveries=async_deliveries)

    def _sync(eng):
        t = 0.0
        for _ in range(rounds):
            t += eng.run_round(t, MSG).duration
        return ()

    t_o_sync, t_f_sync = time_pair(lambda: _sync(eng_oracle),
                                   lambda: _sync(eng_fast), reps=7)
    t_o_async, t_f_async = time_pair(
        lambda: eng_oracle.run_async(0.0, MSG,
                                     n_deliveries=async_deliveries),
        lambda: eng_fast.run_async(0.0, MSG,
                                   n_deliveries=async_deliveries), reps=7)
    return {
        "n_sats": sc.walker.n_sats, "rounds": rounds,
        "deliveries": sum(len(r.deliveries) for r in res_f),
        "round_s_fast": t_f_sync / rounds,
        "round_s_oracle": t_o_sync / rounds,
        "sync_speedup": t_o_sync / t_f_sync,
        "async_s_fast": t_f_async,
        "async_s_oracle": t_o_async,
        "async_speedup": t_o_async / t_f_async,
    }


def bench_trace_overhead(n_sats: int = 1000, rounds: int = 2, seed: int = 0,
                         async_deliveries: int = 100) -> dict:
    """Tracing overhead on sync + async rounds.

    Interleaved min-of-9 of the SAME warmed engine trajectory with the
    :mod:`repro_torch.obs` tracer enabled (in-memory buffer — flush I/O
    is not part of the per-round claim) vs disabled.  The ratio must stay
    under 1.05 from 1000 satellites on.  A single estimate has a fat tail
    on a shared host, so only if the first breaches is it measured once
    more, keeping the better ratio: a real >5 % regression breaches both.
    """
    from .. import obs
    from .timing import time_pair

    eng = Engine(_scenario(n_sats), seed=seed)

    def _run():
        t = 0.0
        for _ in range(rounds):
            t += eng.run_round(t, MSG).duration
        eng.run_async(0.0, MSG, n_deliveries=async_deliveries)
        return ()

    _run()                      # warm: plan build, caches, ARQ plans

    n_events = 0

    def _run_traced():
        nonlocal n_events
        trc = obs.enable()      # fresh in-memory tracer (path=None)
        try:
            _run()
        finally:
            n_events = len(trc.events)
            obs.disable()

    t_off, t_on = time_pair(_run, _run_traced, reps=9)
    overhead = t_on / t_off
    if overhead >= 1.05:        # suspect: re-measure once, keep the better
        t_off2, t_on2 = time_pair(_run, _run_traced, reps=9)
        if t_on2 / t_off2 < overhead:
            t_off, t_on, overhead = t_off2, t_on2, t_on2 / t_off2
    if n_sats >= 1000 and overhead >= 1.05:
        raise AssertionError(
            f"tracing overhead {overhead:.3f}x breaches the <5% budget on "
            f"{n_sats} satellites ({n_events} events per trajectory) — "
            f"emission must stay out of the hot event loops")
    return {"n_sats": _scenario(n_sats).walker.n_sats, "rounds": rounds,
            "async_deliveries": async_deliveries, "events": n_events,
            "s_disabled": t_off, "s_enabled": t_on, "overhead": overhead}


def main(quick: bool = False, rounds: int = 100, seed: int = 0,
         device=None) -> float:
    """The reference's five claims with its printed lines and CSV line;
    returns the contact-plan speedup."""
    t_start = time.time()
    # the headline claim is defined at 100 rounds × 100 sats (--rounds);
    # shorter runs under-amortize the one-off contact-plan build
    walker, gs, link = Walker(), GroundStation(), LinkModel()

    t_seed = bench_seed_path(rounds, walker, gs, link)
    t_plan = bench_plan_path(rounds, walker, gs)
    speedup = t_seed / t_plan
    print(f"scheduling {rounds} rounds x {walker.n_sats} sats: "
          f"seed {t_seed:.3f}s  contact-plan {t_plan:.3f}s  "
          f"speedup {speedup:.1f}x")

    sizes = [100, 1000] if quick else [100, 250, 500, 1000]
    sync_rounds = 3 if quick else 10
    async_n = 100 if quick else 300
    ok_1000 = 0
    for n in sizes:
        r = bench_scale(n, sync_rounds, async_n)
        print(f"  {r['n_sats']:5d} sats: {sync_rounds} sync rounds "
              f"{r['sync_s']:.2f}s ({r['sync_active']} updates), "
              f"{r['async_n']} async deliveries {r['async_s']:.2f}s")
        if n >= 1000 and r["async_n"] > 0:
            ok_1000 = 1

    n_pipe = 100 if quick else 1000
    r = bench_round_pipeline(n_pipe, rounds=2 if quick else 3, seed=seed,
                             device=device)
    print(f"  round pipeline @ {n_pipe} sats: unfused "
          f"{r['round_s_unfused']:.3f}s/round  fused "
          f"{r['round_s_fused']:.3f}s/round  "
          f"speedup {r['speedup']:.1f}x ({r['deliveries']} deliveries)")

    rl = bench_lossy_round(100 if quick else 1000,
                           rounds=2 if quick else 3, seed=seed, device=device)
    print(f"  lossy round @ {rl['n_sats']} sats: lossless "
          f"{rl['round_s_lossless']:.3f}s/round  lossy "
          f"{rl['round_s_lossy']:.3f}s/round  (overhead "
          f"{rl['channel_overhead']:.2f}x, {rl['lost']} lost, "
          f"{rl['retransmissions']} retx)  lossy-uplink fused speedup "
          f"{rl['lossy_uplink_speedup']:.1f}x")

    rf = bench_fast_round(100 if quick else 1000,
                          rounds=2 if quick else 3, seed=seed)
    print(f"  fast round @ {rf['n_sats']} sats: sync "
          f"{rf['sync_speedup']:.2f}x  async {rf['async_speedup']:.1f}x "
          f"vs oracle (bit-for-bit verified, "
          f"{rf['deliveries']} deliveries)")

    rt = bench_trace_overhead(100 if quick else 1000, rounds=2, seed=seed)
    print(f"  trace overhead @ {rt['n_sats']} sats: "
          f"{rt['overhead']:.3f}x enabled vs disabled "
          f"({rt['events']} events/trajectory)")

    us = (time.time() - t_start) * 1e6
    print(f"sim_scale,{us:.0f},speedup={speedup:.1f},sats1000_ok={ok_1000},"
          f"pipeline_speedup={r['speedup']:.1f},"
          f"lossy_overhead={rl['channel_overhead']:.2f}")
    return speedup


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="reduced scales: 2-3 rounds, 100-sat pipeline")
    p.add_argument("--rounds", type=int, default=100,
                   help="scheduling rounds for the contact-plan claim")
    p.add_argument("--seed", type=int, default=0,
                   help="engine / RNG seed for the pipeline benchmarks")
    args = p.parse_args()
    main(quick=args.quick, rounds=args.rounds, seed=args.seed)
