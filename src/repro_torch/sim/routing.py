"""Multi-hop ISL routing over the constellation link graph.

Topology: the classic +grid — each satellite keeps ISLs to its two in-plane
ring neighbours and to the same-slot satellites in the two adjacent planes
(wrapping across the seam where the last plane meets plane 0).  This
replaces the seed's hard-coded "2 in-plane neighbours" relay set: any
satellite within ``max_hops`` of a gateway can forward its update.

Shortest-TIME paths (Dijkstra, per-hop cost = ISL latency + serialization
of the message) rather than hop counts, so heterogeneous link models stay
expressible.  ``routes_to_gateways`` is the hot call: one multi-source
Dijkstra from the round's gateway satellites, bounded by ``max_hops``.

Relay accounting (fixes the seed scheduler's bugs):
  * the seed silently capped relays at 2 (``nbrs[: n_relay]`` over a
    2-tuple) — the router reaches ``n_relay`` satellites per gateway for
    any ``n_relay``;
  * the seed charged ``isl + (i + 2) · gs_time`` per relay, double-counting
    time the ISL transfer spends overlapping the gateway's wait/uplink.
    The engine's event loop serializes messages on the GS link explicitly:
    each message transmits exactly once, starting when BOTH the link is
    free and the message has arrived over the ISL.  :func:`gateway_schedule`
    is the analytic form of that serialization (no window truncation or
    cross-gateway station contention) — the reference model the engine's
    event loop is cross-checked against in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from ..constellation.links import LinkModel
from ..constellation.orbits import Walker, isl_neighbors


@dataclasses.dataclass(frozen=True)
class Route:
    gateway: int
    time: float          # total ISL transfer time to the gateway
    hops: int
    path: Tuple[int, ...]  # sat … gateway inclusive


@dataclasses.dataclass(frozen=True)
class Router:
    walker: Walker
    link: LinkModel = LinkModel()
    cross_plane: bool = True
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def neighbors(self, sat: int) -> Tuple[int, ...]:
        key = ("nbrs", sat)
        nbrs = self._cache.get(key)
        if nbrs is None:
            nbrs = isl_neighbors(self.walker, sat, cross_plane=self.cross_plane)
            self._cache[key] = nbrs
        return nbrs

    def hop_time(self, msg_bytes: float) -> float:
        return self.link.isl_time(msg_bytes)

    def shortest_path(self, src: int, dst: int, msg_bytes: float,
                      max_hops: Optional[int] = None) -> Optional[Route]:
        routes = self.routes_to_gateways([dst], msg_bytes, max_hops=max_hops)
        return routes.get(src)

    def routes_to_gateways(self, gateways: Sequence[int], msg_bytes: float,
                           max_hops: Optional[int] = None
                           ) -> Dict[int, Route]:
        """Multi-source shortest-time routes: for every reachable satellite,
        the ISL route to its nearest gateway.

        Per-hop cost is uniform under the current :class:`LinkModel`, so the
        multi-source Dijkstra degenerates to a layered BFS from the gateway
        set — O(V + E) per call, memoized per (gateway set, message size).
        Gateways themselves map to a 0-hop route; expansion stops at
        ``max_hops`` ISL hops from a gateway.
        """
        key = (tuple(sorted(gateways)), float(msg_bytes), max_hops)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        # bound the memo on long-lived engines: evict oldest route entries
        route_keys = [k for k in self._cache if k[0] != "nbrs"]
        if len(route_keys) >= 256:
            for k in route_keys[:128]:
                del self._cache[k]
        w = self.hop_time(msg_bytes)
        meta: Dict[int, Tuple[int, int, Optional[int]]] = {
            g: (g, 0, None) for g in gateways}          # gateway, hops, pred
        frontier = list(gateways)
        hops = 0
        while frontier and (max_hops is None or hops < max_hops):
            hops += 1
            nxt = []
            for sat in frontier:
                gw = meta[sat][0]
                for nb in self.neighbors(sat):
                    if nb not in meta:
                        meta[nb] = (gw, hops, sat)
                        nxt.append(nb)
            frontier = nxt
        routes = {}
        for sat, (gw, h, _) in meta.items():
            path = [sat]
            while path[-1] != gw:
                path.append(meta[path[-1]][2])
            routes[sat] = Route(gateway=gw, time=h * w, hops=h,
                                path=tuple(path))
        self._cache[key] = routes
        return routes


def gateway_schedule(window_start: float,
                     arrivals: Sequence[Tuple[int, float]],
                     gs_tx: float) -> Dict[int, float]:
    """Serialize one gateway's messages on its GS link — no double counting.

    window_start: when the GS window opens for this gateway;
    arrivals:     (sat, arrival-time-at-gateway) pairs — the gateway's own
                  update (arrival = end of its training) plus forwarded
                  updates (arrival = relay train end + ISL transfer);
    gs_tx:        uplink transmission time of one message.

    Messages transmit back-to-back in arrival order; each charged exactly
    one ``gs_tx``, starting when the link is free AND the message is there.
    Returns {sat: completion time}.  Window-end truncation is the caller's
    (engine's) job — this is the analytic in-window schedule.
    """
    msgs = sorted((a, s) for s, a in arrivals)
    done: Dict[int, float] = {}
    free = window_start
    for arrival, sat in msgs:
        start = max(free, arrival)
        free = start + gs_tx
        done[sat] = free
    return done
