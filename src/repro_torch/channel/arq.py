"""Selective-repeat ARQ over an erasure link, inside one contact window.

A model update of ``nbytes`` is segmented into ``seg_bytes`` CRC-protected
segments.  Each transmission round puts every not-yet-acknowledged segment
on the air (one latency charge per round — the segments stream
back-to-back), the receiver NACKs the erased ones after an ARQ round trip,
and only those are retransmitted — classic selective repeat.  All of this
consumes *real contact-window time*: a round that would run past the
window's set time is truncated mid-flight, the remaining segments never
make it, and the delivery fails (the coordinator discards an update whose
segment set is incomplete).

Timing identities the rest of the simulator relies on:

* zero loss → exactly ONE round taking ``latency + nbytes / rate`` — the
  same float expression as ``LinkModel.gs_time``, so a lossless channel
  reproduces the fixed-rate simulator's accounting bit-for-bit;
* every retransmission round adds ``rtt + latency + retx_bytes / rate``;
* ``nbytes_attempted`` counts every byte put on the air (first rounds and
  retransmissions, including bytes of a truncated round), which is what
  the energy/bandwidth ledger of a real link pays for.

Randomness is injected through a ``draw(round, segs) -> U[0,1) array``
callable (one uniform per segment index in ``segs``, vectorized) — the
:class:`repro_torch.channel.model.ChannelModel` binds it to the deterministic
counter hash of (seed, station, sat, window), keeping outcomes
reproducible and order-independent.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class TxResult:
    """Outcome of one windowed ARQ delivery attempt."""

    t_done: float               # when the link went quiet (success or not)
    delivered: bool             # all segments acknowledged
    nbytes: float               # payload delivered (0.0 when incomplete)
    nbytes_attempted: float     # bytes put on the air, retransmissions incl.
    retries: int                # transmission rounds beyond the first
    n_segments: int
    p_seg: float                # erasure probability the attempt saw


@dataclasses.dataclass
class ArqPlan:
    """Precomputed profile of one ARQ delivery over a TIME-INVARIANT link
    (fixed rate and erasure probability, i.e. ``budget=None`` channels).

    The erasure pattern of a delivery is a pure counter-hash of
    (seed, station, sat, window) — independent of when the transmission
    starts — so everything except window truncation can be computed once
    and replayed: :meth:`replay` re-runs only the ``t``/truncation
    arithmetic of :meth:`SelectiveRepeatARQ.transmit`, in the same float
    operation order, and therefore reproduces its :class:`TxResult`
    bit-for-bit for any ``(t_start, window_end)``.  Built by
    :meth:`SelectiveRepeatARQ.plan` from ONE batched counter draw over
    the whole (round, segment) grid instead of one draw per round.
    """

    rtt: float
    latency: float
    rate: float                 # bytes/s the truncation maths sees
    nbytes: float
    n_segments: int
    p_last: float               # erasure probability every round saw
    bursts: list                # per executed round: bytes put on the air
    t_airs: list                # per executed round: air time of the burst
    attempted_before: list      # attempted-bytes ledger entering each round
    attempted_total: float
    delivered: bool             # all segments landed within max_rounds

    def replay(self, t_start: float, window_end: float) -> TxResult:
        """Replay the planned delivery inside ``[t_start, window_end)``."""
        t = float(t_start)
        for k, t_air in enumerate(self.t_airs):
            if k > 0:
                t += self.rtt                      # wait for the NACK set
            if t + t_air > window_end:
                # truncated mid-window: count the bytes that made it out
                on_air = max(0.0, (window_end - t - self.latency)) * self.rate
                attempted = (self.attempted_before[k]
                             + min(self.bursts[k], max(on_air, 0.0)))
                return TxResult(float(window_end), False, 0.0, attempted,
                                k, self.n_segments, self.p_last)
            t += t_air
        rounds = len(self.t_airs)
        if not self.delivered:
            return TxResult(t, False, 0.0, self.attempted_total, rounds - 1,
                            self.n_segments, self.p_last)
        return TxResult(t, True, float(self.nbytes), self.attempted_total,
                        rounds - 1, self.n_segments, self.p_last)


@dataclasses.dataclass(frozen=True)
class SelectiveRepeatARQ:
    """Segmentation + retransmission policy (link-agnostic)."""

    seg_bytes: int = 1024       # segment payload granularity
    max_rounds: int = 4         # transmission rounds (1 initial + retx)
    rtt: float = 0.04           # NACK round-trip between rounds (s)

    def segment_sizes(self, nbytes: float) -> list:
        """Byte size of each segment (last one may be short)."""
        n_seg = max(1, math.ceil(nbytes / self.seg_bytes))
        sizes = [float(self.seg_bytes)] * n_seg
        sizes[-1] = nbytes - self.seg_bytes * (n_seg - 1)
        return sizes

    def plan(self, nbytes: float, *, rate: float, p_seg: float,
             latency: float,
             draw: Callable[[np.ndarray, np.ndarray], np.ndarray],
             gs_time: Optional[Callable[[float], float]] = None) -> ArqPlan:
        """Precompute a replayable :class:`ArqPlan` for a time-invariant
        link (``rate``/``p_seg`` scalars, not callables).

        Runs the same round loop as :meth:`transmit` — same burst sums in
        the same order, same per-round air-time expressions, same
        surviving-segment filtering — but samples the WHOLE
        (round, segment) uniform grid in one batched ``draw`` call (the
        counter hash is elementwise, so ``u[k, segs]`` equals what
        ``transmit``'s per-round ``draw(k, segs)`` would have returned)
        and records the per-round ledger :meth:`ArqPlan.replay` needs.
        """
        sizes = self.segment_sizes(nbytes)
        n_seg = len(sizes)
        if p_seg > 0.0:
            u = draw(np.arange(self.max_rounds, dtype=np.int64)[:, None],
                     np.arange(n_seg, dtype=np.int64)[None, :])
        remaining = list(range(n_seg))
        bursts: list = []
        t_airs: list = []
        attempted_before: list = []
        attempted = 0.0
        rounds = 0
        while remaining and rounds < self.max_rounds:
            burst = sum(sizes[i] for i in remaining)
            if gs_time is not None and len(remaining) == n_seg:
                t_air = gs_time(burst)             # exact fixed-rate path
            else:
                t_air = latency + burst / rate
            bursts.append(burst)
            t_airs.append(t_air)
            attempted_before.append(attempted)
            attempted += burst
            rounds += 1
            if p_seg > 0.0:
                segs = np.asarray(remaining)
                remaining = [int(i) for i in segs[u[rounds - 1, segs] < p_seg]]
            else:
                remaining = []
        return ArqPlan(rtt=self.rtt, latency=latency, rate=rate,
                       nbytes=nbytes, n_segments=n_seg,
                       p_last=float(p_seg), bursts=bursts, t_airs=t_airs,
                       attempted_before=attempted_before,
                       attempted_total=attempted,
                       delivered=not remaining)

    def transmit(self, nbytes: float, t_start: float, window_end: float,
                 *, rate: Callable[[float], float],
                 p_seg: Callable[[float], float],
                 latency: float,
                 draw: Callable[[int, np.ndarray], np.ndarray],
                 gs_time: Optional[Callable[[float], float]] = None
                 ) -> TxResult:
        """Run the ARQ state machine inside ``[t_start, window_end)``.

        ``rate(t)`` / ``p_seg(t)`` give the instantaneous link state (the
        budget evaluates them at each round's start — elevation changes
        between retransmissions of a long pass).  ``gs_time``, when given,
        computes a full-message round time directly; it exists so the
        fixed-rate channel reuses ``LinkModel.gs_time``'s exact float
        expression for the single-round zero-loss case.
        """
        sizes = self.segment_sizes(nbytes)
        remaining = list(range(len(sizes)))
        t = float(t_start)
        attempted = 0.0
        p_last = 0.0
        rounds = 0
        while remaining and rounds < self.max_rounds:
            if rounds > 0:
                t += self.rtt                      # wait for the NACK set
            r = rate(t)
            p_last = p_seg(t)
            burst = sum(sizes[i] for i in remaining)
            if gs_time is not None and len(remaining) == len(sizes):
                t_air = gs_time(burst)             # exact fixed-rate path
            else:
                t_air = latency + burst / r
            if t + t_air > window_end:
                # truncated mid-window: count the bytes that made it out
                on_air = max(0.0, (window_end - t - latency)) * r
                attempted += min(burst, max(on_air, 0.0))
                # the link stays claimed until the window closes under it
                return TxResult(float(window_end), False, 0.0,
                                attempted, rounds, len(sizes), p_last)
            attempted += burst
            t += t_air
            rounds += 1
            if p_last > 0.0:
                segs = np.asarray(remaining)
                u = draw(rounds - 1, segs)
                remaining = [int(i) for i in segs[u < p_last]]
            else:
                remaining = []
        if remaining:
            return TxResult(t, False, 0.0, attempted, rounds - 1,
                            len(sizes), p_last)
        return TxResult(t, True, float(nbytes), attempted, rounds - 1,
                        len(sizes), p_last)
