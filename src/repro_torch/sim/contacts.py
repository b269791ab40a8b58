"""Precomputed contact plans: rise/set intervals for every (station, sat) pair.

The seed scheduler re-propagated a 720-step visibility grid on every
``select`` call — O(rounds · T · S).  A :class:`ContactPlan` propagates the
whole horizon ONCE (O(T · S) vectorized), extracts the rise/set intervals
with a single ``diff`` over the boolean grid, and answers "when does
satellite *s* next see a station after time *t*" with array lookups:
O(log W) scalar, or fully vectorized over all satellites at once.

Interval semantics match brute-force grid scanning: a window is
``[rise, set)`` where ``rise`` is the first grid time with the link up and
``set`` the first grid time after it with the link down (a window still open
at the end of the horizon is capped at ``horizon_end + dt``).  Windows are
stored as per-station ``(S, W_max)`` arrays padded with ``+inf`` so batch
queries are plain numpy.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..constellation.orbits import GroundStation, Walker, visibility_grid


class ContactPlan:
    """Contact windows for ``walker`` against every station in ``stations``.

    Attributes (per station index ``g``):
        rises[g]: (S, W) window start times, +inf-padded
        sets[g]:  (S, W) window end times (exclusive), +inf-padded
    """

    def __init__(self, walker: Walker, stations: Sequence[GroundStation],
                 horizon: float = 86400.0, dt: float = 10.0, t_start: float = 0.0):
        self.walker = walker
        self.stations = tuple(stations)
        self.dt = float(dt)
        self.t_start = float(t_start)
        self.horizon = float(horizon)
        self._build()

    # -- construction -----------------------------------------------------
    def _grid(self) -> np.ndarray:
        """The immutable time grid covering the current horizon."""
        return self.t_start + np.arange(0.0, self.horizon, self.dt)

    def _build(self) -> None:
        ts = self._grid()
        n = self.walker.n_sats
        rises, sets, last_vis = [], [], []
        for gs in self.stations:
            vis = visibility_grid(self.walker, gs, ts).view(np.int8)  # (T, S)
            padded = np.zeros((vis.shape[0] + 2, n), dtype=np.int8)
            padded[1:-1] = vis
            d = np.diff(padded, axis=0)                       # (T+1, S)
            r_t, r_s = np.where(d == 1)                       # rise at ts[r_t]
            s_t, s_s = np.where(d == -1)                      # set  at ts[s_t]
            # set index T means "still visible at horizon end" — cap there
            s_val = np.where(s_t < len(ts), ts[np.minimum(s_t, len(ts) - 1)],
                             ts[-1] + self.dt)
            rises.append(self._to_padded(r_s, ts[r_t], n))
            sets.append(self._to_padded(s_s, s_val, n))
            last_vis.append(vis[-1].astype(bool))
        self.rises = rises
        self.sets = sets
        self._last_vis = last_vis
        self._n_steps = len(ts)

    def _extend(self, old_steps: int) -> None:
        """Incrementally extend the window arrays to the (already grown)
        horizon: propagate ONLY the new ``[old_end, horizon)`` grid
        segment and merge its windows into the existing padded arrays.

        Produces bit-identical ``rises``/``sets`` to a from-scratch
        ``_build`` over the full horizon: the extension grid is a slice
        of the full ``arange`` grid, a window that was capped at the old
        horizon end either gets its true set time patched in (the link
        dropped inside the new segment) or its cap moved to the new
        horizon end, and rise/set extraction runs the same diff-over-
        boolean-grid logic seeded with the cached visibility at the old
        boundary.  This turns the amortized cost of horizon doubling
        from O(total · rebuilds) into O(total) — the difference between
        ~10 s and sub-second mega-10000 rounds.
        """
        ts = self._grid()
        new_ts = ts[old_steps:]
        if new_ts.size == 0:
            return
        n = self.walker.n_sats
        t_add = len(new_ts)
        cap = ts[-1] + self.dt
        for g, gs in enumerate(self.stations):
            vis = visibility_grid(self.walker, gs, new_ts).view(np.int8)
            padded = np.zeros((t_add + 2, n), dtype=np.int8)
            padded[0] = self._last_vis[g]     # continuity across the seam
            padded[1:-1] = vis
            d = np.diff(padded, axis=0)                       # (T_add+1, S)
            r_t, r_s = np.where(d == 1)
            s_t, s_s = np.where(d == -1)
            s_val = np.where(s_t < t_add, new_ts[np.minimum(s_t, t_add - 1)],
                             cap)
            old_r, old_s = self.rises[g], self.sets[g]
            n_old = np.count_nonzero(np.isfinite(old_r), axis=1)  # (S,)
            was_open = self._last_vis[g]
            # column layout: windows occupy a contiguous prefix per sat.
            # A sat open at the seam contributes its FIRST set event to
            # the old capped window (column n_old-1); everything else
            # appends after the old prefix.
            n_new = np.bincount(r_s, minlength=n)
            w_need = int((n_old + n_new).max(initial=0))
            w_max = max(old_r.shape[1], w_need, 1)
            rises = np.full((n, w_max), np.inf)
            sets = np.full((n, w_max), np.inf)
            rises[:, :old_r.shape[1]] = old_r
            sets[:, :old_s.shape[1]] = old_s
            # np.where scans time-major; lexsort to (sat, time) rank order
            order = np.lexsort((s_t, s_s))
            ss = s_s[order]
            rank = np.arange(len(ss)) - np.searchsorted(ss, ss)
            sets[ss, n_old[ss] + rank - was_open[ss]] = s_val[order]
            order = np.lexsort((r_t, r_s))
            rs = r_s[order]
            rank = np.arange(len(rs)) - np.searchsorted(rs, rs)
            rises[rs, n_old[rs] + rank] = new_ts[r_t[order]]
            self.rises[g] = rises
            self.sets[g] = sets
            self._last_vis[g] = (vis[-1] if t_add else self._last_vis[g]) \
                .astype(bool)
        self._n_steps = len(ts)

    @staticmethod
    def _to_padded(sats: np.ndarray, times: np.ndarray, n: int) -> np.ndarray:
        """Scatter (sat, time) pairs (time-ordered per sat — np.where scans
        time-major) into an +inf-padded (S, W_max) array."""
        w_max = max(1, int(np.bincount(sats, minlength=n).max(initial=0)))
        pad = np.full((n, w_max), np.inf)
        order = np.lexsort((times, sats))
        s_sorted, t_sorted = sats[order], times[order]
        col = np.arange(len(order)) - np.searchsorted(s_sorted, s_sorted)
        pad[s_sorted, col] = t_sorted
        return pad

    def ensure(self, t_end: float) -> None:
        """Extend the plan (amortized doubling) to cover queries up to
        ``t_end``.  Only the new time segment is propagated
        (:meth:`_extend`); existing windows are never recomputed."""
        if t_end <= self.t_start + self.horizon:
            return
        old_steps = self._n_steps
        while self.t_start + self.horizon < t_end:
            self.horizon *= 2.0
        self._extend(old_steps)

    # -- queries ----------------------------------------------------------
    @property
    def n_stations(self) -> int:
        return len(self.stations)

    def windows(self, station: int, sat: int) -> list:
        """All (rise, set) windows of one satellite at one station."""
        r, s = self.rises[station][sat], self.sets[station][sat]
        keep = np.isfinite(r)
        return list(zip(r[keep], s[keep]))

    def next_window(self, sat: int, t: float,
                    station: Optional[int] = None,
                    blocked: Optional[list] = None
                    ) -> Optional[Tuple[float, float, int]]:
        """Earliest window with ``set > t`` → (start, end, station) or None.

        ``start`` may be ≤ t if the satellite is currently in contact.
        ``blocked``: optional per-station (S, W) bool arrays — windows to
        skip (link dropout / weather), as in :meth:`next_windows_all`.
        """
        best, best_eff = None, np.inf
        gs_range = range(self.n_stations) if station is None else (station,)
        for g in gs_range:
            s = self.sets[g][sat]
            i = int(np.searchsorted(s, t, side="right"))
            while i < s.shape[0] and np.isfinite(self.rises[g][sat][i]):
                if (blocked is None or blocked[g] is None
                        or not blocked[g][sat, i]):
                    cand = (float(self.rises[g][sat][i]), float(s[i]), g)
                    eff = max(cand[0], t)         # earliest usable start
                    if eff < best_eff:
                        best, best_eff = cand, eff
                    break
                i += 1
        return best

    def next_windows_all(self, t: np.ndarray, blocked: Optional[list] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized :meth:`next_window` over every satellite.

        t: scalar or (S,) per-satellite query times.
        blocked: optional per-station (S, W) bool — windows to skip
                 (link dropout / weather).
        Returns (start (S,), end (S,), station (S,)); start=+inf where no
        window exists.  start is clipped up to the query time.
        """
        return self.next_windows_for(np.arange(self.walker.n_sats), t,
                                     blocked=blocked)

    def next_windows_for(self, sats: np.ndarray, t: np.ndarray,
                         blocked: Optional[list] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """:meth:`next_windows_all` restricted to a satellite subset.

        sats: (B,) satellite indices (any order, duplicates fine);
        t: scalar or (B,) per-query times.  Same elementwise arithmetic
        as the all-satellite path, so the two agree bit-for-bit on
        shared rows — the fast engine's batched route chooser relies on
        this when a dispatch batch touches only a candidate neighborhood
        instead of the whole constellation.
        """
        rows = np.asarray(sats, dtype=np.int64)
        b = rows.shape[0]
        t = np.broadcast_to(np.asarray(t, dtype=np.float64), (b,))
        best_start = np.full(b, np.inf)
        best_end = np.full(b, np.inf)
        best_g = np.full(b, -1, dtype=np.int64)
        ar = np.arange(b)
        for g in range(self.n_stations):
            ok = self.sets[g][rows] > t[:, None]
            if blocked is not None and blocked[g] is not None:
                ok &= ~blocked[g][rows]
            i = np.argmax(ok, axis=1)                 # first usable window
            valid = ok[ar, i]
            start = np.where(valid, self.rises[g][rows, i], np.inf)
            start = np.maximum(start, t)
            end = np.where(valid, self.sets[g][rows, i], np.inf)
            better = start < best_start
            best_start = np.where(better, start, best_start)
            best_end = np.where(better, end, best_end)
            best_g = np.where(better, g, best_g)
        return best_start, best_end, best_g

    def in_contact(self, sat: int, t: float) -> Optional[int]:
        """Station index the satellite can currently reach, else None."""
        w = self.next_window(sat, t)
        if w is not None and w[0] <= t < w[1]:
            return w[2]
        return None
