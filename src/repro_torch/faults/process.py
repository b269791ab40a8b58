"""Deterministic fault-injection processes for the constellation sim.

Node-level failures layered on top of the link-level channel:
satellite radiation upsets, ground-station blackouts, and cluster-head
failures mid-convergecast.  All draws use the same counter-based
splitmix64 idiom as :mod:`repro_torch.channel.outage` — a draw is a pure
function of ``(seed, namespace, identity counters)``, never of call
order or of how far the contact plan has been extended — so both sim
engines (heapq oracle and vectorized fast path) observe bit-identical
fault timelines, and extending the plan horizon never retroactively
changes a fault the run already consulted.

Fault classes
-------------

* **Satellite crash/reboot** (radiation-upset MTBF model).  Each uplink
  flight of satellite ``s`` starting at ``t_start`` with exposure
  ``T = t_done - t_start`` crashes with probability
  ``p = 1 - (1 - crash_rate) * exp(-T / crash_mtbf)`` — a flat
  per-flight term (benchmark sweeps) composed with an exposure-
  proportional MTBF term (physics).  The draw is keyed on
  ``(sat, bits(t_start))`` so it is identical in both engines and
  stable under plan extension.  The reboot completes within the round
  (MTBF >> round length); the sat rejoins with a wiped memory.

* **Ground-station blackout**.  Time is divided into slots of
  ``gs_outage_duration`` seconds; station ``g`` is dark in slot ``j``
  with probability ``gs_outage_rate``, keyed on ``(station, slot)``.
  A contact window whose rise falls in a dark slot is unusable, which
  forces the scheduler to re-route traffic through other stations,
  windows, or ISL relays — exactly like the weather/conjunction masks
  the engine already applies.

* **Cluster-head failure** (plane convergecast).  The elected head of
  plane ``p`` fails mid-aggregation with probability
  ``head_failure_rate``, keyed on ``(plane, bits(t0))``.  Arc partial
  sums already absorbed by the dead head are lost with it; arcs still
  in flight are salvaged and re-routed to a re-elected head after a
  ``failover_timeout`` detection delay (see
  :func:`repro_torch.sim.topology` for the failover mechanics).

Crash vs. link-loss semantics for error feedback
------------------------------------------------

The two loss modes are deliberately NOT the same for EF state:

* **Erasure (link loss, straggler past deadline, head-failover
  collateral)** — the satellite is alive and still holds its EF
  residual.  Loss-robust EF reverts both the coordinator wire
  (``z_hat``) and the residual (``c_up``) to their pre-round values,
  so the lost content telescopes into the next round's correction:
  *residual kept*.

* **Crash (radiation upset, failed head's own update)** — the
  satellite reboots with wiped memory.  The coordinator wire reverts
  exactly as for an erasure (nothing arrived), but the residual is
  gone: ``c_up`` for the crashed sat is re-synced to zero
  (:func:`repro_torch.core.error_feedback.resync_cache`): *residual lost*.
  The content of the destroyed residual is simply never recovered —
  the price of a crash that no retransmission protocol can refund.

Round deadlines and quorum
--------------------------

:func:`quorum_close_time` computes when a round closes under a
deadline-with-quorum policy: the round ends at ``t0 + deadline``
provided at least ``ceil(quorum * n_attempted)`` update-weights have
landed; otherwise it extends to the landing instant of the quorum-th
weight (or the last landing, if even that never reaches quorum).
Deliveries landing after the close are *stragglers* — treated as
erasures (residual kept), so their content folds into the next round
via EF rather than being discarded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ..channel.outage import counter_uniforms

# Counter namespaces — distinct leading tags so fault draws can never
# collide with RainFade (tags 1, 2) or each other.
NS_CRASH = 101        # crash event draw        (sat, bits(t_start))
NS_CRASH_T = 102      # crash instant draw      (sat, bits(t_start))
NS_GS = 103           # station-dark draw       (station, slot)
NS_HEAD = 104         # head-failure draw       (plane, bits(t0))
NS_HEAD_T = 105       # head-failure instant    (plane, bits(t0))


def time_key(t) -> np.ndarray:
    """Bit-pattern of a float64 time as a uint64 counter.

    Times are produced identically by both engines (bit-for-bit
    equivalence contract), so their bit patterns are stable identities —
    no grid rounding, no collisions between distinct instants.
    """
    return np.asarray(t, dtype=np.float64).view(np.uint64)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Configuration of the deterministic fault processes.

    All rates default to "off" so ``FaultModel()`` is a no-op; scenarios
    opt in per fault class.  ``salt`` decorrelates the fault stream from
    the engine's channel/weather streams that share the scenario seed.
    """

    crash_rate: float = 0.0            # flat per-flight upset probability
    crash_mtbf: float = float("inf")   # mean time between upsets (s)
    gs_outage_rate: float = 0.0        # P(station dark in a given slot)
    gs_outage_duration: float = 1800.0  # dark-slot length (s)
    head_failure_rate: float = 0.0     # P(head fails) per plane-round
    failover_timeout: float = 60.0     # failure detection + re-election (s)
    salt: int = 0x5EED_FA17            # decorrelate from channel draws

    def __post_init__(self) -> None:
        if not 0.0 <= self.crash_rate < 1.0:
            raise ValueError(f"crash_rate must be in [0,1): {self.crash_rate}")
        if self.crash_mtbf <= 0.0:
            raise ValueError(f"crash_mtbf must be > 0: {self.crash_mtbf}")
        if not 0.0 <= self.gs_outage_rate < 1.0:
            raise ValueError(
                f"gs_outage_rate must be in [0,1): {self.gs_outage_rate}")
        if self.gs_outage_duration <= 0.0:
            raise ValueError("gs_outage_duration must be > 0")
        if not 0.0 <= self.head_failure_rate <= 1.0:
            raise ValueError(
                f"head_failure_rate must be in [0,1]: {self.head_failure_rate}")
        if self.failover_timeout < 0.0:
            raise ValueError("failover_timeout must be >= 0")

    # -- feature flags ------------------------------------------------
    @property
    def crashes_enabled(self) -> bool:
        return self.crash_rate > 0.0 or math.isfinite(self.crash_mtbf)

    @property
    def gs_enabled(self) -> bool:
        return self.gs_outage_rate > 0.0

    @property
    def head_enabled(self) -> bool:
        return self.head_failure_rate > 0.0

    @property
    def active(self) -> bool:
        return self.crashes_enabled or self.gs_enabled or self.head_enabled

    # -- crash process ------------------------------------------------
    def crash_prob(self, exposure) -> np.ndarray:
        """Per-flight upset probability for the given exposure time(s)."""
        exp_term = 1.0
        if math.isfinite(self.crash_mtbf):
            exp_term = np.exp(-np.maximum(np.asarray(exposure, float), 0.0)
                              / self.crash_mtbf)
        return 1.0 - (1.0 - self.crash_rate) * exp_term

    def crash_mask(self, seed: int, sats, t_starts, exposures) -> np.ndarray:
        """Bool array: did flight (sat, t_start) suffer an upset in-flight?"""
        u = counter_uniforms(seed + self.salt, NS_CRASH,
                             np.asarray(sats), time_key(t_starts))
        return u < self.crash_prob(exposures)

    def crash_times(self, seed: int, sats, t_starts, exposures) -> np.ndarray:
        """Upset instant within the flight (decorates fault events)."""
        u = counter_uniforms(seed + self.salt, NS_CRASH_T,
                             np.asarray(sats), time_key(t_starts))
        return np.asarray(t_starts, float) + u * np.asarray(exposures, float)

    # -- ground-station blackout --------------------------------------
    def station_dark(self, seed: int, station: int, times) -> np.ndarray:
        """Bool array: is ``station`` dark at each of ``times``?

        Keyed on the outage slot index, so every query inside one slot
        agrees and plan extension appends new slots without disturbing
        old ones.
        """
        t = np.asarray(times, dtype=np.float64)
        ok = np.isfinite(t)
        slot = np.floor(np.where(ok, t, 0.0)
                        / self.gs_outage_duration).astype(np.int64)
        u = counter_uniforms(seed + self.salt, NS_GS, int(station), slot)
        dark = u < self.gs_outage_rate
        return dark & ok

    # -- cluster-head failure -----------------------------------------
    def head_failure(self, seed: int, plane: int, t0: float
                     ) -> Optional[float]:
        """Fractional failure instant for (plane, round at t0), or None.

        Returns ``f in [0,1)`` — the head fails at
        ``t0 + f * (t_ready - t0)`` — when the draw fires, else None.
        """
        u = counter_uniforms(seed + self.salt, NS_HEAD,
                             int(plane), time_key(t0))
        if float(u) >= self.head_failure_rate:
            return None
        frac = counter_uniforms(seed + self.salt, NS_HEAD_T,
                                int(plane), time_key(t0))
        return float(frac)

    def describe(self) -> str:
        """Compact label for ledger meta (stable across runs)."""
        parts = []
        if self.crash_rate > 0.0:
            parts.append(f"crash{self.crash_rate:g}")
        if math.isfinite(self.crash_mtbf):
            parts.append(f"mtbf{self.crash_mtbf:g}")
        if self.gs_enabled:
            parts.append(f"gs{self.gs_outage_rate:g}"
                         f"x{self.gs_outage_duration:g}")
        if self.head_enabled:
            parts.append(f"head{self.head_failure_rate:g}")
        return "-".join(parts) if parts else "none"


def describe_faults(fm: Optional[FaultModel]) -> str:
    """Ledger-meta label for a fault model (``"none"`` when absent)."""
    return fm.describe() if fm is not None else "none"


# -- round deadlines with quorum --------------------------------------

def quorum_close_time(t0: float, deadline: float, quorum: float,
                      landed: Sequence[Tuple[float, int]],
                      n_attempted: int) -> float:
    """Close time of a round under a deadline-with-quorum policy.

    ``landed`` is a sequence of ``(t_done, weight)`` pairs for successful
    deliveries (weight = number of member updates the delivery carries —
    1 for direct uplinks, the merged-plane size for convergecast heads).
    The round closes at ``t0 + deadline`` if at least
    ``ceil(quorum * n_attempted)`` weight has landed by then; otherwise
    it extends to the landing that completes the quorum (or the last
    landing when quorum is unreachable — nothing more will ever arrive,
    so waiting longer is pointless).
    """
    t_dl = float(t0) + float(deadline)
    need = int(math.ceil(quorum * max(int(n_attempted), 0)))
    if need <= 0:
        return t_dl
    order = sorted(landed, key=lambda p: p[0])
    total = 0
    for t_done, w in order:
        if t_done > t_dl:
            break
        total += int(w)
    if total >= need:
        return t_dl
    # extend past the deadline until quorum is met (or supply runs out)
    total = 0
    for t_done, w in order:
        total += int(w)
        if total >= need:
            return max(t_dl, float(t_done))
    return max(t_dl, float(order[-1][0])) if order else t_dl
