"""Outage processes layered on contact windows: rain fade + conjunctions.

Two impairments that dominate LEO availability beyond plain geometry
(Razmi et al., Matthiesen et al. both center intermittent connectivity):

* :class:`RainFade` — per-(station, window) stochastic attenuation.  Each
  contact window independently suffers a fade event with probability
  ``p_fade``; the fade depth is exponential with mean ``mean_db`` (a crude
  but standard single-parameter fit of rain-attenuation exceedance
  curves).  The draw is a DETERMINISTIC counter-based hash of
  (seed, station, sat, window-rise index) — the same convention as the
  engine's weather mask — so extending the contact plan never
  retroactively changes a fade the simulation already consulted.

* :class:`ConjunctionBlackout` — deterministic recurring blackout
  intervals (collision-avoidance maneuvers, solar conjunction, station
  keep-out): every ``period`` seconds the link is down for ``duration``
  seconds, phase-shifted per station so multi-station scenarios degrade
  gracefully.  A transmission scheduled inside a blackout is simply not
  attempted; windows fully covered by a blackout are unusable.

Both processes are pure functions — no mutable state — so the engine can
query them at any (station, sat, window, t).
"""
from __future__ import annotations

import dataclasses

import numpy as np

_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)
_MIX3 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer → uniform uint64 (vectorized)."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _MIX2
    x ^= x >> np.uint64(27)
    x *= _MIX3
    x ^= x >> np.uint64(31)
    return x


def counter_uniforms(seed: int, *counters) -> np.ndarray:
    """Deterministic U[0,1) from integer counter tuples (splitmix64 hash).

    The host-side sibling of the CUDA erasure-mask kernel's counter RNG:
    the same (seed, counters) always yields the same draw, independent of
    call order — which is what makes ARQ outcomes and fade depths
    reproducible under contact-plan extension.  Any counter may be an
    integer array; counters broadcast together and an array of draws comes
    back (one hash chain per element, vectorized).
    """
    with np.errstate(over="ignore"):
        x = np.uint64(seed % 2**64) * _MIX1
        for i, c in enumerate(counters):
            c = np.asarray(c)
            if c.dtype.kind != "u":
                c = c.astype(np.int64).astype(np.uint64)
            x = _splitmix64(x ^ (c + np.uint64(i + 1) * _MIX3))
    return x.astype(np.float64) / float(2**64)


def counter_uniform(seed: int, *counters: int) -> float:
    """Scalar convenience wrapper over :func:`counter_uniforms`."""
    return float(counter_uniforms(seed, *counters))


@dataclasses.dataclass(frozen=True)
class RainFade:
    """Per-window exponential rain attenuation on the GS link."""

    p_fade: float = 0.3          # P(a window has a fade event at all)
    mean_db: float = 6.0         # mean attenuation of a fade event

    def fade_db(self, seed: int, station: int, sat: int,
                window_id: int) -> float:
        """Attenuation (dB) applying to one whole contact window."""
        u_event = counter_uniform(seed, 1, station, sat, window_id)
        if u_event >= self.p_fade:
            return 0.0
        u_depth = counter_uniform(seed, 2, station, sat, window_id)
        # inverse-CDF exponential; clamp the tail so log(0) can't appear
        return float(-self.mean_db * np.log(max(1.0 - u_depth, 1e-12)))


@dataclasses.dataclass(frozen=True)
class ConjunctionBlackout:
    """Deterministic recurring link blackouts (maneuvers / conjunctions)."""

    period: float = 6 * 3600.0   # seconds between blackout starts
    duration: float = 900.0      # blackout length
    station_phase: float = 1800.0  # phase offset per station index

    def blacked_out(self, station: int, t: float) -> bool:
        """True when ``t`` falls inside a blackout at ``station``."""
        phase = (float(t) - station * self.station_phase) % self.period
        return phase < self.duration

    def next_clear(self, station: int, t: float) -> float:
        """Earliest time ≥ t outside a blackout at ``station``."""
        phase = (float(t) - station * self.station_phase) % self.period
        if phase >= self.duration:
            return float(t)
        return float(t) + (self.duration - phase)
