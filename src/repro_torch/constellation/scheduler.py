"""Round-time-minimizing scheduling policy (Kim et al., 2025 style).

Refactored into a *policy object* plugged into the discrete-event engine
(``repro_torch.sim.engine.Engine``):

  * :meth:`Scheduler.assign` picks the round's participants from the
    precomputed contact plan — ``k_direct`` satellites with the soonest
    usable GS windows become gateways, and each gateway pulls up to
    ``n_relay`` additional satellites over multi-hop ISL routes (nearest
    first, ≤ ``max_hops`` hops) — the paper's "space-ification": more
    participants per round without more sat-to-ground links.
  * :meth:`Scheduler.select` keeps the seed's ``(mask, duration)`` API by
    executing one engine round — completion times come from explicit
    event-level GS-link serialization, which fixes two seed bugs: relays
    are no longer silently capped at 2 (the seed sliced a 2-tuple of
    in-plane neighbours), and no transmission phase is double-counted
    (the seed charged ``isl + (i + 2) · gs_time`` per relay even though
    the ISL transfer overlaps the wait for the window).

Unlike the seed — which re-propagated a 720-step visibility grid on every
``select`` call — windows come from a :class:`~repro_torch.sim.contacts.ContactPlan`
computed once over the whole horizon (``legacy_select`` below preserves the
seed path as the benchmark baseline and regression reference).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .links import LinkModel
from .orbits import GroundStation, Walker


@dataclasses.dataclass
class Assignment:
    """One round's schedule, produced by a policy for the engine."""
    gateways: List[int]                        # direct-uplink sats, by window
    windows: Dict[int, Tuple[float, float, int]]  # gateway → (start, end, gs)
    relays: Dict[int, object]                  # sat → routing.Route


@dataclasses.dataclass(frozen=True)
class Scheduler:
    walker: Walker
    gs: object                   # GroundStation or tuple of GroundStations
    link: LinkModel = LinkModel()
    k_direct: int = 4
    n_relay: int = 2             # forwarded satellites per gateway
    compute_time: object = 30.0  # scalar or (S,) on-board training seconds
    lookahead: float = 7200.0
    dt: float = 10.0
    max_hops: int = 4
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def stations(self) -> tuple:
        return tuple(self.gs) if isinstance(self.gs, (tuple, list)) else (self.gs,)

    # -- policy interface (called by the engine) ---------------------------
    def assign(self, t0: float, msg_bytes: float, engine) -> Assignment:
        sc = engine.scenario
        n = sc.walker.n_sats
        compute = np.broadcast_to(
            np.asarray(sc.compute_time, dtype=np.float64), (n,))
        t_ready = t0 + compute
        start, end, station = engine.usable_windows_all(t_ready)
        cand = np.where(np.isfinite(start) & (start <= t0 + self.lookahead))[0]
        order = cand[np.argsort(start[cand], kind="stable")]
        gateways = [int(s) for s in order[: self.k_direct]]
        if not gateways:
            return Assignment([], {}, {})
        windows = {g: (float(start[g]), float(end[g]), int(station[g]))
                   for g in gateways}
        routes = engine.router.routes_to_gateways(gateways, msg_bytes,
                                                  max_hops=self.max_hops)
        gw_set = set(gateways)
        load = {g: 0 for g in gateways}
        relays: Dict[int, object] = {}
        for sat in sorted(routes,
                          key=lambda s: (routes[s].time, routes[s].hops, s)):
            r = routes[sat]
            if sat in gw_set or r.hops == 0:
                continue
            if load[r.gateway] < self.n_relay:
                relays[sat] = r
                load[r.gateway] += 1
        return Assignment(gateways, windows, relays)

    # -- seed-compatible API ----------------------------------------------
    def _engine(self):
        eng = self._cache.get("engine")
        if eng is None:
            from ..sim.engine import Engine, Scenario  # lazy: breaks cycle
            sc = Scenario(name="scheduler", walker=self.walker,
                          stations=self.stations, link=self.link,
                          compute_time=self.compute_time,
                          k_direct=self.k_direct, n_relay=self.n_relay,
                          max_hops=self.max_hops, lookahead=self.lookahead,
                          dt=self.dt)
            eng = Engine(sc, policy=self)
            self._cache["engine"] = eng
        return eng

    def select(self, t0: float, msg_bytes: float,
               rng: Optional[np.random.Generator] = None
               ) -> Tuple[np.ndarray, float]:
        """Returns (active bool (n_sats,), round_duration_seconds)."""
        res = self._engine().run_round(t0, msg_bytes)
        return res.mask, float(res.duration)


def legacy_select(walker: Walker, gs: GroundStation, link: LinkModel,
                  t0: float, msg_bytes: float, k_direct: int = 4,
                  n_relay: int = 2, compute_time: float = 30.0
                  ) -> Tuple[np.ndarray, float]:
    """The seed scheduler, verbatim: re-propagates the whole visibility grid
    on every call and relays only the two in-plane neighbours, with the
    known accounting bugs (relay cap at 2, double-counted uplink term).
    Kept as the benchmark baseline and as the parity/regression reference.
    """
    from .orbits import in_plane_neighbors, visible

    n = walker.n_sats
    ts = t0 + np.arange(0.0, 7200.0, 10.0)
    vis = visible(walker, gs, ts)                    # (T, S)
    first = np.argmax(vis, axis=0)
    has = vis[first, np.arange(n)]
    waits = np.where(has, first * 10.0, np.inf)
    order = np.argsort(waits)
    direct = [s for s in order[:k_direct] if np.isfinite(waits[s])]
    active = set(direct)
    completion = {}
    for s in direct:
        tx = link.gs_time(msg_bytes)
        completion[s] = compute_time + waits[s] + tx
        nbrs = in_plane_neighbors(walker, s)
        for i, nb in enumerate(nbrs[:n_relay]):
            if nb in active:
                continue
            active.add(nb)
            completion[nb] = (compute_time + waits[s]
                              + link.isl_time(msg_bytes)
                              + (i + 2) * link.gs_time(msg_bytes))
    mask = np.zeros(n, bool)
    for s in active:
        mask[s] = True
    duration = max(completion.values()) if completion else compute_time
    return mask, float(duration)
