"""ChannelModel — the stochastic link-impairment facade the engine drives.

Bundles the three impairment layers into one object a
:class:`repro_torch.sim.engine.Scenario` can carry (``Scenario.channel``):

* **link budget** (:class:`repro_torch.channel.budget.LinkBudget`) — elevation-
  dependent rate and segment-erasure probability.  ``budget=None`` is the
  fixed-rate special case: rates and latency come from the scenario's
  ``LinkModel`` unchanged and ``loss`` gives a flat per-segment erasure
  probability, so ``ChannelModel()`` (all defaults) reproduces the
  lossless simulator's ``Delivery`` byte/time accounting exactly;
* **outage processes** (:mod:`repro_torch.channel.outage`) — per-window rain
  fades feed extra dB into the budget; conjunction blackouts mask whole
  windows (the engine folds them into its blocked-window arrays);
* **ARQ** (:class:`repro_torch.channel.arq.SelectiveRepeatARQ`) — selective
  repeat whose retransmissions consume real window time and can truncate
  a delivery mid-window.

All randomness is counter-based: a draw is a pure hash of
``(engine seed, channel seed, station, sat, window id, round, segment)``
(:func:`repro_torch.channel.outage.counter_uniform`), so outcomes never depend
on event-processing order or contact-plan extension.  The device-side
sibling is the CUDA erasure-mask kernel
(:mod:`repro_torch.kernels.erasure_mask`), which applies the same
counter-hash → threshold decision to packed wire words in batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..constellation.links import LinkModel
from ..constellation.orbits import GroundStation, Walker
from ..obs.trace import active as _obs_active
from .arq import ArqPlan, SelectiveRepeatARQ, TxResult
from .budget import LinkBudget, elevation_at
from .outage import ConjunctionBlackout, RainFade, counter_uniforms


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """One GS-uplink impairment stack (ISLs stay ideal — the sat↔GS leg
    dominates both loss and rate in LEO federated uplinks)."""

    budget: Optional[LinkBudget] = None   # None → fixed LinkModel rates
    arq: SelectiveRepeatARQ = SelectiveRepeatARQ()
    loss: float = 0.0                     # flat p_seg when budget is None
    rain: Optional[RainFade] = None
    blackout: Optional[ConjunctionBlackout] = None
    seed: int = 0

    # -- link state --------------------------------------------------------
    def fade_db(self, seed: int, station: int, sat: int,
                window_id: int) -> float:
        if self.rain is None:
            return 0.0
        return self.rain.fade_db(seed ^ self.seed, station, sat, window_id)

    def rate(self, link: LinkModel, elevation_deg: float,
             fade_db: float = 0.0) -> float:
        """Instantaneous GS-link rate (bytes/s)."""
        if self.budget is None:
            return link.gs_rate
        return self.budget.rate(elevation_deg, fade_db)

    def p_seg(self, elevation_deg: float, fade_db: float = 0.0) -> float:
        """Per-segment erasure probability at the given link state."""
        if self.budget is None:
            return float(self.loss)
        return self.budget.p_seg(elevation_deg, self.arq.seg_bytes, fade_db)

    # -- scheduling estimate ----------------------------------------------
    def estimate_time(self, link: LinkModel, nbytes: float, *,
                      walker: Walker, station_obj: GroundStation,
                      gateway: int, t: float, seed: int, station: int,
                      window_id: int) -> float:
        """Expected air time for window-fit checks (channel-aware
        scheduling): one-round time scaled by the expected transmission
        count per segment, ``1/(1−p)``.  Exactly ``LinkModel.gs_time``
        when the channel is lossless and fixed-rate.  Geometry and fade
        belong to the *gateway* — the satellite holding the GS link."""
        fade = self.fade_db(seed, station, gateway, window_id)
        if self.budget is None:
            base = link.gs_time(nbytes)
            p = float(self.loss)
        else:
            el = elevation_at(walker, station_obj, gateway, t)
            base = link.gs_latency + nbytes / self.rate(link, el, fade)
            p = self.p_seg(el, fade)
        if p <= 0.0:
            return base
        return base / max(1.0 - min(p, 0.9), 0.1)

    @property
    def time_invariant(self) -> bool:
        """True when rate/erasure probability don't depend on the
        transmission instant — the fixed-rate (``budget=None``) stack.
        Only then is a transmission replayable from an :class:`ArqPlan`."""
        return self.budget is None

    def arq_plan(self, link: LinkModel, nbytes: float, *, sat: int,
                 seed: int, station: int, window_id: int) -> ArqPlan:
        """Precomputed replayable delivery profile (fast-engine hot path).

        Mirrors :meth:`transmit`'s fixed-rate branch argument-for-argument
        — same constant rate/p/latency, same ``gs_time`` exact-path
        condition, same counter mix — so
        ``arq_plan(...).replay(t_start, window_end)`` returns the
        identical :class:`TxResult` bit-for-bit.  Erasure counters depend
        only on (seed, station, sat, window), so one plan serves every
        retry of the same update through the same window and caches
        across benchmark repetitions.  Raises on elevation-dependent
        (``budget``) channels — those must transmit through the oracle
        path.
        """
        if not self.time_invariant:
            raise ValueError("arq_plan requires a time-invariant channel "
                             "(budget=None); elevation-dependent budgets "
                             "must use transmit()")
        mix = (seed * 0x1F3F) ^ self.seed

        def draw(rnd, segs):
            return counter_uniforms(mix, station, sat, window_id, rnd, segs)

        return self.arq.plan(
            nbytes, rate=link.gs_rate, p_seg=float(self.loss),
            latency=link.gs_latency, draw=draw,
            gs_time=None if self.loss > 0.0 else link.gs_time)

    # -- transmission ------------------------------------------------------
    def transmit(self, link: LinkModel, nbytes: float, *,
                 walker: Walker, station_obj: GroundStation, gateway: int,
                 sat: int, t_start: float, window_end: float, seed: int,
                 station: int, window_id: int) -> TxResult:
        """Run one windowed ARQ delivery with this channel's link state.

        ``gateway`` is the transmitting satellite (elevation geometry and
        rain fade); ``sat`` identifies the update on the wire (erasure
        draw counters), so two updates relayed through the same gateway
        window share the fade but draw independent erasures.
        """
        fade = self.fade_db(seed, station, gateway, window_id)
        mix = (seed * 0x1F3F) ^ self.seed

        def draw(rnd, segs):
            return counter_uniforms(mix, station, sat, window_id, rnd, segs)

        if self.budget is None:
            return self.arq.transmit(
                nbytes, t_start, window_end,
                rate=lambda t: link.gs_rate,
                p_seg=lambda t: float(self.loss),
                latency=link.gs_latency, draw=draw,
                gs_time=None if self.loss > 0.0 else link.gs_time)

        def rate_at(t: float) -> float:
            return self.budget.rate(
                elevation_at(walker, station_obj, gateway, t), fade)

        def p_at(t: float) -> float:
            return self.budget.p_seg(
                elevation_at(walker, station_obj, gateway, t),
                self.arq.seg_bytes, fade)

        res = self.arq.transmit(nbytes, t_start, window_end, rate=rate_at,
                                p_seg=p_at, latency=link.gs_latency,
                                draw=draw)
        trc = _obs_active()
        if trc is not None:
            # budget-branch only: link-budget state per transmission.  The
            # fixed-rate branch stays silent — the fast engine replays
            # those via ArqPlan without calling transmit(), and per-link
            # SNR is a constant there anyway.  "link" events are therefore
            # NOT part of obs.summary.DIFF_KINDS.
            el = elevation_at(walker, station_obj, gateway, t_start)
            trc.event("link", station=int(station), sat=int(sat),
                      gateway=int(gateway), window_id=int(window_id),
                      t_start=float(t_start),
                      elevation_deg=float(el), fade_db=float(fade),
                      rate=float(self.budget.rate(el, fade)),
                      p_seg=float(res.p_seg), retries=int(res.retries),
                      delivered=bool(res.delivered),
                      nbytes_attempted=float(res.nbytes_attempted),
                      t_done=float(res.t_done))
            if fade > 0.0:
                trc.metrics.histogram("fade_db").observe(float(fade))
            trc.metrics.histogram("link_p_seg").observe(float(res.p_seg))
        return res
