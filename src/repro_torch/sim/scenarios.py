"""Named simulation scenarios — register your own with :func:`register`.

A scenario bundles everything the engine needs: the Walker constellation,
the ground-station set, the link budget, per-satellite compute times, a
weather/dropout model, and (optionally) a stochastic lossy channel
(:class:`repro_torch.channel.ChannelModel`).  Built-ins cover the paper's
default setting plus the harder regimes the realistic-space-scenario
comparison needs:

    walker-kiruna       the seed setting — 100 sats, one polar GS, uniform
                        30 s compute, clear sky (parity baseline)
    dual-station        Kiruna + Svalbard: twice the window supply
    weather-dropout     dual-station with 25 % of contact windows blocked
    hetero-compute      per-satellite compute times spread 15–60 s
                        (deterministic pattern — no RNG in scenario defs)
    mega-1000           1000 sats / 20 planes, three stations, 8 gateways
                        per round — the scale target from the ROADMAP
    mega-10000          10000 sats / 40 planes, 16 gateways per round —
                        the dense mega-constellation regime (bench-only)

  lossy-channel scenarios (``Scenario.channel``, :mod:`repro_torch.channel`):

    lossy-uplink        walker-kiruna over a flat 10 % segment-erasure
                        channel with selective-repeat ARQ (fixed rates) —
                        the loss-robust-EF experiment setting
    rain-fade           dual-station Ka-band: healthy clear-sky margin,
                        but 40 % of windows suffer an exponential rain
                        fade that crushes rate and erasure probability
    ka-band-degraded    walker-kiruna on a marginal Ka-band budget —
                        elevation-dependent rates; low passes are lossy,
                        high passes clean
    conjunction-outage  walker-kiruna with recurring conjunction
                        blackouts masking whole contact windows
    mega-1000-lossy     mega-1000 over a flat 25 % erasure channel with
                        3 ARQ rounds — scale + loss combined, with a real
                        (~14 %) lost-delivery fraction

  fault-injection scenarios (``Scenario.faults``, :mod:`repro_torch.faults`):

    chaos-direct        walker-kiruna with radiation-upset crashes and
                        ground-station blackouts (fault-equivalence smoke)
    chaos-plane         plane aggregation with mid-convergecast head
                        failures → timeout re-election + partial salvage
    chaos-lossy         erasures and crashes composed in one round
    mega-1000-chaos     the headline robustness regime: scale + loss +
                        crashes + station blackouts
    mega-1000-chaos-plane   the same at plane topology with head failover

Usage::

    from repro_torch.sim import get_scenario, Engine
    eng = Engine(get_scenario("dual-station"))

    @register("my-scenario")
    def _my():                      # factory, called per get_scenario()
        return Scenario(name="my-scenario", walker=Walker(n_sats=40), ...)
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..channel import (ChannelModel, ConjunctionBlackout, LinkBudget,
                       RainFade, SelectiveRepeatARQ)
from ..constellation.orbits import GroundStation, Walker
from ..faults import FaultModel
from .engine import Scenario

SCENARIOS: Dict[str, Callable[[], Scenario]] = {}

KIRUNA = GroundStation(lat=67.86, lon=20.22)
SVALBARD = GroundStation(lat=78.23, lon=15.39)
INUVIK = GroundStation(lat=68.32, lon=-133.55)


def register(name: str):
    """Decorator: register a zero-arg Scenario factory under ``name``."""
    def deco(fn: Callable[[], Scenario]):
        SCENARIOS[name] = fn
        return fn
    return deco


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {names()}")
    return SCENARIOS[name]()


def names() -> List[str]:
    return sorted(SCENARIOS)


@register("walker-kiruna")
def _walker_kiruna() -> Scenario:
    return Scenario(name="walker-kiruna", walker=Walker(), stations=(KIRUNA,))


@register("dual-station")
def _dual_station() -> Scenario:
    return Scenario(name="dual-station", walker=Walker(),
                    stations=(KIRUNA, SVALBARD))


@register("weather-dropout")
def _weather_dropout() -> Scenario:
    return Scenario(name="weather-dropout", walker=Walker(),
                    stations=(KIRUNA, SVALBARD), dropout=0.25)


@register("hetero-compute")
def _hetero_compute() -> Scenario:
    w = Walker()
    # deterministic 15–60 s spread: radiation-tolerant flight computers of
    # five different generations, interleaved across the constellation
    compute = 15.0 + 45.0 * (np.arange(w.n_sats) % 5) / 4.0
    return Scenario(name="hetero-compute", walker=w, stations=(KIRUNA,),
                    compute_time=compute)


@register("mega-1000")
def _mega_1000() -> Scenario:
    return Scenario(name="mega-1000",
                    walker=Walker(n_sats=1000, n_planes=20),
                    stations=(KIRUNA, SVALBARD, INUVIK),
                    k_direct=8, n_relay=4, max_hops=6)


@register("mega-10000")
def _mega_10000() -> Scenario:
    # dense mega-constellation regime (Razmi et al., Matthiesen et al.):
    # 10k sats / 40 planes, three polar stations, 16 gateways per round
    return Scenario(name="mega-10000",
                    walker=Walker(n_sats=10000, n_planes=40),
                    stations=(KIRUNA, SVALBARD, INUVIK),
                    k_direct=16, n_relay=4, max_hops=6)


# ---------------------------------------------------------------------------
# lossy-channel scenarios (repro_torch.channel) — stochastic link impairments
# layered on the contact windows.  All channel elements are deterministic
# functions of (engine seed, station, sat, window), so factories stay
# RNG-free as required.
# ---------------------------------------------------------------------------

@register("lossy-uplink")
def _lossy_uplink() -> Scenario:
    # the loss-robust-EF experiment setting (benchmarks/table_lossy_ef.py):
    # fixed LinkModel rates, flat 10 % segment erasure, selective repeat
    return Scenario(name="lossy-uplink", walker=Walker(), stations=(KIRUNA,),
                    channel=ChannelModel(
                        loss=0.10,
                        arq=SelectiveRepeatARQ(seg_bytes=1024, max_rounds=4)))


@register("rain-fade")
def _rain_fade() -> Scenario:
    # healthy clear-sky Ka-band margin; 40 % of windows carry an
    # exponential rain fade (mean 8 dB) that crushes rate and raises the
    # erasure probability for the whole pass
    return Scenario(name="rain-fade", walker=Walker(),
                    stations=(KIRUNA, SVALBARD),
                    channel=ChannelModel(
                        budget=LinkBudget(eirp_dbw=26.0),
                        rain=RainFade(p_fade=0.4, mean_db=8.0)))


@register("ka-band-degraded")
def _ka_band_degraded() -> Scenario:
    # marginal link budget: the elevation profile dominates — low passes
    # are erasure-heavy and slow, near-zenith passes clean and fast
    return Scenario(name="ka-band-degraded", walker=Walker(),
                    stations=(KIRUNA,),
                    channel=ChannelModel(budget=LinkBudget(eirp_dbw=22.0)))


@register("conjunction-outage")
def _conjunction_outage() -> Scenario:
    # recurring conjunction / maneuver keep-outs: every 3 h the station
    # drops for 25 min, masking every window rising inside the blackout
    return Scenario(name="conjunction-outage", walker=Walker(),
                    stations=(KIRUNA,),
                    channel=ChannelModel(
                        blackout=ConjunctionBlackout(period=3 * 3600.0,
                                                     duration=1500.0)))


# ---------------------------------------------------------------------------
# in-orbit aggregation scenarios (repro_torch.sim.topology) — per-plane
# convergecast to elected cluster heads; one merged wire per plane (or per
# head pair, under gossip) crosses the GS link instead of one per sat
# ---------------------------------------------------------------------------

@register("plane-agg-walker")
def _plane_agg_walker() -> Scenario:
    # the seed geometry with per-plane aggregation: ≤ 10 head uplinks per
    # round instead of k_direct + relays, every member of a live plane
    # participating — the topology-equivalence smoke scenario
    return Scenario(name="plane-agg-walker", walker=Walker(),
                    stations=(KIRUNA,), topology="plane")


@register("plane-agg-gossip")
def _plane_agg_gossip() -> Scenario:
    # plane aggregation + paired inter-head merge: ~half the uplinks again,
    # at the cost of the inter-head ISL transfer
    return Scenario(name="plane-agg-gossip", walker=Walker(),
                    stations=(KIRUNA,), topology="gossip")


@register("plane-agg-lossy")
def _plane_agg_lossy() -> Scenario:
    # plane aggregation over a harsh erasure channel: one segment per
    # typical message and no retransmission, so ~25 % of HEAD wires are
    # destroyed — each loss reverts a whole plane's worth of updates,
    # the stress case for loss-robust EF under mid-route aggregation
    return Scenario(name="plane-agg-lossy", walker=Walker(),
                    stations=(KIRUNA,), topology="plane",
                    channel=ChannelModel(
                        loss=0.25,
                        arq=SelectiveRepeatARQ(seg_bytes=16384,
                                               max_rounds=1)))


@register("mega-1000-plane")
def _mega_1000_plane() -> Scenario:
    # the mega-1000 regime aggregated in orbit: ≤ 20 head uplinks carry
    # all 1000 updates — the bytes-to-ground headline of
    # benchmarks/table_plane_agg.py
    return Scenario(name="mega-1000-plane",
                    walker=Walker(n_sats=1000, n_planes=20),
                    stations=(KIRUNA, SVALBARD, INUVIK),
                    max_hops=6, topology="plane")


@register("mega-1000-lossy")
def _mega_1000_lossy() -> Scenario:
    # scale + loss combined: the mega-1000 regime over a flat 25 %
    # erasure channel with 3 ARQ rounds (bench_lossy_round's headline
    # scenario).  The original 10 %/4-round setting had a per-delivery
    # loss probability of ~1e-3 — the bench's lost_frac sat at exactly
    # 0.0, so the loss-revert path was never exercised at scale; at
    # 25 %/3 rounds roughly one delivery in seven is lost (asserted >0
    # in the bench) while most of the fleet still lands.
    return Scenario(name="mega-1000-lossy",
                    walker=Walker(n_sats=1000, n_planes=20),
                    stations=(KIRUNA, SVALBARD, INUVIK),
                    k_direct=8, n_relay=4, max_hops=6,
                    channel=ChannelModel(
                        loss=0.25,
                        arq=SelectiveRepeatARQ(seg_bytes=1024, max_rounds=3)))


# ---------------------------------------------------------------------------
# fault-injection scenarios (repro_torch.faults) — node- and station-level
# failures layered on top of link impairments.  Fault draws are
# counter-based (seed, namespace, entity, time-bits), so the factories
# stay RNG-free and both engines see identical faults.
# ---------------------------------------------------------------------------

@register("chaos-direct")
def _chaos_direct() -> Scenario:
    # the seed geometry with radiation upsets + ground-station blackouts:
    # ~8 % of flights crash mid-round (losing the in-flight update AND
    # the EF residual) and Kiruna goes dark in ~15 % of half-hour slots —
    # the small fast-vs-oracle fault-equivalence scenario
    return Scenario(name="chaos-direct", walker=Walker(),
                    stations=(KIRUNA,),
                    faults=FaultModel(crash_rate=0.08,
                                      gs_outage_rate=0.15,
                                      gs_outage_duration=1800.0))


@register("chaos-plane")
def _chaos_plane() -> Scenario:
    # per-plane convergecast under head failures: ~30 % of head uplinks
    # die mid-convergecast, triggering timeout re-election and partial-
    # sum salvage; member crashes exercise the residual re-sync path
    return Scenario(name="chaos-plane", walker=Walker(),
                    stations=(KIRUNA,), topology="plane",
                    faults=FaultModel(crash_rate=0.05,
                                      head_failure_rate=0.30,
                                      failover_timeout=60.0))


@register("chaos-lossy")
def _chaos_lossy() -> Scenario:
    # erasures AND crashes in the same round: link losses revert wires
    # but keep residuals, crashes wipe both — the scenario where the two
    # EF semantics (revert vs re-sync) must compose correctly
    return Scenario(name="chaos-lossy", walker=Walker(), stations=(KIRUNA,),
                    channel=ChannelModel(
                        loss=0.10,
                        arq=SelectiveRepeatARQ(seg_bytes=1024, max_rounds=4)),
                    faults=FaultModel(crash_rate=0.08))


@register("mega-1000-chaos")
def _mega_1000_chaos() -> Scenario:
    # the headline robustness regime (benchmarks/table_fault_tolerance.py
    # and the chaos convergence gate): mega-1000 over a lossy channel with
    # per-flight radiation upsets and recurring station blackouts
    return Scenario(name="mega-1000-chaos",
                    walker=Walker(n_sats=1000, n_planes=20),
                    stations=(KIRUNA, SVALBARD, INUVIK),
                    k_direct=8, n_relay=4, max_hops=6,
                    channel=ChannelModel(
                        loss=0.10,
                        arq=SelectiveRepeatARQ(seg_bytes=1024, max_rounds=3)),
                    faults=FaultModel(crash_rate=0.05,
                                      gs_outage_rate=0.10,
                                      gs_outage_duration=1800.0))


@register("mega-1000-chaos-plane")
def _mega_1000_chaos_plane() -> Scenario:
    # the in-orbit aggregation variant: 20 planes convergecast to heads
    # while ~20 % of head uplinks fail mid-round — failover + partial-sum
    # salvage at mega-constellation scale
    return Scenario(name="mega-1000-chaos-plane",
                    walker=Walker(n_sats=1000, n_planes=20),
                    stations=(KIRUNA, SVALBARD, INUVIK),
                    max_hops=6, topology="plane",
                    faults=FaultModel(crash_rate=0.03,
                                      head_failure_rate=0.20,
                                      failover_timeout=60.0))
