"""Vectorized batch-event fast path for the discrete-event engine.

The heapq engine (:meth:`repro_torch.sim.engine.Engine._run_round_oracle` /
:meth:`~repro_torch.sim.engine.Engine._run_async_oracle`) pops one event at a
time, allocates a kwargs dict per event, re-runs a breadth-first ISL
search per routing decision, and re-evaluates the stochastic channel
(elevation → rate → erasure, per-round counter draws) from scratch on
every window-fit check.  None of that is algorithmically necessary:

* **batch-event core** — events are flat immutable records in a
  :class:`EventQueue` (no kwargs dict per event); whole event cohorts
  materialize from numpy arrays in one heapify, and consecutive events
  sharing a timestamp and a dispatchable kind pop as ONE batch;
* **batched routing** — each dispatch batch resolves its routes through
  the already-array-shaped contact-plan lookups
  (:meth:`~repro_torch.sim.contacts.ContactPlan.next_windows_for`): one
  vectorized window query per ISL hop distance instead of
  ``O(candidates)`` scalar ``next_window`` calls per satellite, with the
  per-satellite BFS neighborhoods precomputed once from the +grid
  translation symmetry (:class:`_Topology`);
* **vectorized channel** — time-invariant (``budget=None``) channels
  precompute each delivery's full ARQ profile from one batched
  splitmix64 counter draw over the (round, segment) grid
  (:class:`repro_torch.channel.arq.ArqPlan`) and replay it per transmission;
  elevation-dependent estimates memoize on their full argument tuple
  (:class:`ChannelCache`).

Equivalence is the contract, speed is the feature: for any scenario and
seed the fast path reproduces the oracle's :class:`~repro_torch.sim.engine.
Delivery` timeline — every field, bit for bit — because every cached or
batched quantity is computed with the oracle's exact float expressions
(see the per-class notes), and event ordering replicates the oracle's
``(t, push-sequence)`` total order.  ``tests/test_fastpath_equivalence``
enforces this across sync/async × lossless/lossy/rain-fade/mega
scenarios; CI runs the mega-1000 smoke on every push.

Observability attaches at the :meth:`~repro_torch.sim.engine.Engine.run_round`
/ :meth:`~repro_torch.sim.engine.Engine.run_async` wrappers — NOT here — so
this path and the oracle emit ``repro_torch.obs`` trace records through one
shared schema and ``python -m repro.obs diff`` can localize the first
diverging record between the two engines.  (One asymmetry: time-invariant
channels here replay :class:`~repro_torch.channel.arq.ArqPlan` without calling
``ChannelModel.transmit``, so per-transmission ``link`` events only
appear on budget channels; ``link`` is excluded from the diff kinds.)
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np

from ..obs.trace import active as _obs_active

# event kinds (EventQueue.kind values)
TRAIN = 0       # a satellite finished local training
ISL = 1         # an update arrived at a gateway over the ISL mesh
TX_START = 2    # wakeup: a gateway's window opened / link came free
TX_DONE = 3     # a GS uplink completed (success or channel failure)
RETRY = 4       # async: no route anywhere, try again later
_DISPATCH = (TRAIN, RETRY)    # kinds that batch-pop into one dispatch


class EventQueue:
    """Batch event queue over flat immutable records.

    Each event is one ``(t, seq, kind, a, b, c, d, f)`` record — no
    per-event kwargs dict, the allocation the oracle pays on every push.
    ``seq`` is a monotone push counter, so the heap's ``(t, seq)`` total
    order is exactly the oracle's ``(t, itertools.count())`` order and
    ties at equal timestamps resolve identically.  :meth:`push_batch`
    materializes a whole event cohort from numpy arrays in one heapify;
    :meth:`peek` lets the engine batch-pop consecutive same-timestamp
    dispatch events.  Channel outcomes (TX_DONE only) ride in a side
    table keyed by ``seq``.

    Record fields by kind:  ``a`` = sat (TRAIN/ISL/RETRY) or gateway
    (TX_START/TX_DONE); ``b`` = gateway (ISL) or sat (TX_DONE);
    ``c`` = ISL hops; ``d`` = station; ``f`` = window rise time.
    """

    __slots__ = ("_heap", "_seq", "outcomes")

    def __init__(self):
        self._heap: list = []
        self._seq = 0
        self.outcomes: Dict[int, dict] = {}        # TX_DONE channel outcome

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, t: float, kind: int, a: int = 0, b: int = 0, c: int = 0,
             d: int = 0, f: float = 0.0, outcome: Optional[dict] = None
             ) -> None:
        i = self._seq
        self._seq = i + 1
        if outcome is not None:
            self.outcomes[i] = outcome
        heapq.heappush(self._heap, (t, i, kind, a, b, c, d, f))

    def push_batch(self, ts: np.ndarray, kind: int, sats) -> None:
        """One event per (t, sat) pair, in index order (one heapify when
        the queue starts empty — the async round-start cohort)."""
        i0 = self._seq
        self._seq = i0 + len(ts)
        recs = [(t, i0 + j, kind, s, 0, 0, 0, 0.0)
                for j, (t, s) in enumerate(zip(ts.tolist(), sats.tolist()))]
        if self._heap:
            for r in recs:
                heapq.heappush(self._heap, r)
        else:
            self._heap = recs
            heapq.heapify(self._heap)

    def pop(self):
        return heapq.heappop(self._heap)

    def peek(self):
        return self._heap[0] if self._heap else None


class ChannelCache:
    """Per-engine memo for the stochastic channel stack.

    Every cached quantity is exactly what the oracle computes for the
    same arguments: ARQ profiles replay ``transmit()``'s float
    arithmetic (:class:`~repro_torch.channel.arq.ArqPlan`), estimates memoize
    on the full ``(gateway, station, window, t, nbytes)`` tuple, and the
    fixed-rate estimate collapses to one float per message size (it
    never depended on geometry).  Plans are pure functions of
    (seed, station, sat, window, nbytes) — they never invalidate, and
    they're what turns the per-round lossy-channel overhead from ~6x
    into the gated ≤ 2x.
    """

    def __init__(self, engine):
        self.eng = engine
        self.channel = engine.channel
        self._plans: dict = {}
        self._est: dict = {}
        self._flat_est: dict = {}

    def _live_channel(self):
        """The engine's channel is mutable (``SpaceRunner`` installs one
        post-construction) — drop every memo when it changes identity."""
        ch = self.eng.channel
        if ch is not self.channel:
            self.channel = ch
            self._plans.clear()
            self._est.clear()
            self._flat_est.clear()
        return ch

    def estimate(self, gateway: int, win, t: float, nbytes: float,
                 gs_tx: float) -> float:
        ch = self._live_channel()
        if ch is None:
            return gs_tx
        if ch.time_invariant:
            e = self._flat_est.get(nbytes)
            if e is None:
                if len(self._flat_est) > (1 << 16):  # content-exact codecs
                    self._flat_est.clear()           # vary nbytes per round
                e = self.eng.tx_estimate(gateway, win, t, nbytes, gs_tx)
                self._flat_est[nbytes] = e
            return e
        key = (gateway, win[2], self.eng._window_id(win[0]), t, nbytes)
        e = self._est.get(key)
        if e is None:
            if len(self._est) > (1 << 16):     # bound long-lived engines
                self._est.clear()
            e = self.eng.tx_estimate(gateway, win, t, nbytes, gs_tx)
            self._est[key] = e
        return e

    def commit(self, gateway: int, sat: int, win, t: float, nbytes: float,
               gs_tx: float):
        ch = self._live_channel()
        if ch is None:
            return t + gs_tx, dict(nbytes=nbytes, nbytes_attempted=nbytes,
                                   retries=0, delivered=True)
        if ch.time_invariant:
            wid = self.eng._window_id(win[0])
            key = (win[2], sat, wid, nbytes)
            plan = self._plans.get(key)
            if plan is None:
                if len(self._plans) > (1 << 16):   # bound long-lived engines
                    self._plans.clear()
                plan = ch.arq_plan(self.eng.scenario.link, nbytes, sat=sat,
                                   seed=self.eng.seed, station=win[2],
                                   window_id=wid)
                self._plans[key] = plan
            res = plan.replay(t, win[1])
            return res.t_done, dict(nbytes=res.nbytes,
                                    nbytes_attempted=res.nbytes_attempted,
                                    retries=res.retries,
                                    delivered=res.delivered)
        # elevation-dependent budget: rate/p vary with the transmission
        # instant — not replayable, route through the oracle path
        return self.eng.tx_commit(gateway, sat, win, t, nbytes, gs_tx)


class _Topology:
    """Oracle-order BFS neighborhoods, precomputed for the whole fleet.

    The async oracle re-runs ``reachable(sat)`` (a bounded BFS over the
    +grid) on EVERY dispatch.  The +grid is translation-invariant on the
    (plane, slot) torus whenever the constellation is regular
    (``n_sats == n_planes · sats_per_plane``): the BFS from satellite 0
    yields per-hop (Δplane, Δslot) offsets that are valid — in the same
    insertion order the oracle's ``dict`` iteration produces — for every
    satellite.  One BFS therefore builds the full ``(S, C)`` candidate /
    hop arrays.  Invariance is spot-checked against the literal BFS at
    construction; ragged constellations fall back to per-satellite BFS
    (still computed once, not per dispatch).
    """

    def __init__(self, engine):
        sc = engine.scenario
        self.router = engine.router
        self.max_hops = sc.max_hops
        w = sc.walker
        n = w.n_sats
        spp = w.sats_per_plane
        regular = spp > 0 and spp * w.n_planes == n
        if regular:
            offsets = self._bfs(0)                       # [(sat, hops)]
            dp = np.array([v // spp for v, _ in offsets])
            ds = np.array([v % spp for v, _ in offsets])
            hp = np.array([h for _, h in offsets], dtype=np.int64)
            plane = np.arange(n, dtype=np.int64) // spp
            slot = np.arange(n, dtype=np.int64) % spp
            ids = (((plane[:, None] + dp[None, :]) % w.n_planes) * spp
                   + (slot[:, None] + ds[None, :]) % spp)
            # spot-check the translation symmetry before trusting it
            for probe in {n // 3, n - 1} - {0}:
                ref = self._bfs(probe)
                if (len(ref) != len(offsets)
                        or any(ids[probe, k] != v or hp[k] != h
                               for k, (v, h) in enumerate(ref))):
                    regular = False
                    break
        if regular:
            self.ids = ids
            self.hops = np.broadcast_to(hp, ids.shape)
            self.valid = None
        else:
            rows = [self._bfs(s) for s in range(n)]
            c = max(len(r) for r in rows)
            self.ids = np.zeros((n, c), dtype=np.int64)
            self.hops = np.zeros((n, c), dtype=np.int64)
            self.valid = np.zeros((n, c), dtype=bool)
            for s, row in enumerate(rows):
                for k, (v, h) in enumerate(row):
                    self.ids[s, k] = v
                    self.hops[s, k] = h
                    self.valid[s, k] = True

    def _bfs(self, sat: int):
        """The oracle's ``reachable``: (candidate, hops) in insertion
        order — hops are nondecreasing, so the oracle's est tie-break
        (prefer fewer hops) reduces to first-minimum order."""
        seen = {sat: 0}
        frontier = [sat]
        for h in range(1, self.max_hops + 1):
            nxt = []
            for u in frontier:
                for v in self.router.neighbors(u):
                    if v not in seen:
                        seen[v] = h
                        nxt.append(v)
            frontier = nxt
        return list(seen.items())


class _FastState:
    """Lazily-built per-engine fast-path caches (topology + ISL times)."""

    def __init__(self, engine):
        self.topo = _Topology(engine)
        self._isl: dict = {}
        self._link = engine.router.link
        self._max_hops = engine.scenario.max_hops

    def isl_times(self, msg_bytes: float) -> np.ndarray:
        """(max_hops+1,) per-hop-count ISL transfer times; index 0 is the
        oracle's literal 0.0 for the direct (hops == 0) case."""
        arr = self._isl.get(msg_bytes)
        if arr is None:
            arr = np.array([0.0] + [self._link.isl_time(msg_bytes, hops=h)
                                    for h in range(1, self._max_hops + 1)])
            self._isl[msg_bytes] = arr
        return arr


# ---------------------------------------------------------------------------
# synchronous mode
# ---------------------------------------------------------------------------

def run_round_fast(eng, t0: float, msg_bytes: float):
    """Fast sync round: the oracle's event protocol — same pushes in the
    same order, so the same ``(t, seq)`` pop order — over the structured
    event store, with every channel evaluation served by the
    :class:`ChannelCache`."""
    from .engine import Delivery, RoundResult

    sc = eng.scenario
    trc = _obs_active()
    prof = trc.prof if trc is not None else None
    eng.ensure(t0 + 2 * sc.lookahead)
    if prof is not None:
        prof.begin("assign")
    asg = eng.policy.assign(t0, msg_bytes, eng)
    if prof is not None:
        prof.end()
    n = sc.walker.n_sats
    scheduled = np.zeros(n, dtype=bool)
    for s in asg.gateways:
        scheduled[s] = True
    for s in asg.relays:
        scheduled[s] = True
    if not asg.gateways:
        return RoundResult(np.zeros(n, dtype=bool), sc.max_compute, [],
                           scheduled, t0)

    gs_tx = sc.link.gs_time(msg_bytes)
    if prof is not None:
        prof.begin("state_build")
    cache = eng.chan_cache          # lazily built on the first round
    if prof is not None:
        prof.end()
    ev = EventQueue()
    queues = {g: [] for g in asg.gateways}
    busy = {g: False for g in asg.gateways}
    wins = {g: asg.windows[g] for g in asg.gateways}
    station_free: Dict[int, float] = defaultdict(float)
    deliveries: List = []
    hops_of = {s: r.hops for s, r in asg.relays.items()}

    for s in asg.gateways:
        ev.push(t0 + sc.compute_of(s), TRAIN, a=s)
    for s in asg.relays:
        ev.push(t0 + sc.compute_of(s), TRAIN, a=s)

    # hot-interior accumulators [fit_n, fit_s, commit_n, commit_s]:
    # inline perf_counter reads, folded into the profiler once per round
    pacc = [0, 0.0, 0, 0.0]

    def try_tx(g, t):
        if busy[g] or not queues[g]:
            return
        _t0 = perf_counter() if prof is not None else 0.0
        win = wins[g]
        fit = False
        for _ in range(64):
            if win is None:
                break
            start = max(t, win[0], station_free[win[2]])
            if start + cache.estimate(g, win, start, msg_bytes,
                                      gs_tx) <= win[1]:
                fit = True
                break
            win = eng.usable_window(g, win[1])
        if prof is not None:
            pacc[0] += 1
            pacc[1] += perf_counter() - _t0
        if not fit:                         # undeliverable this round
            queues[g].clear()
            wins[g] = None
            return
        wins[g] = win
        if start > t:
            ev.push(start, TX_START, a=g)
            return
        _, sat = queues[g].pop(0)           # FIFO = arrival order
        busy[g] = True
        _t0 = perf_counter() if prof is not None else 0.0
        t_done, outcome = cache.commit(g, sat, win, t, msg_bytes, gs_tx)
        if prof is not None:
            pacc[2] += 1
            pacc[3] += perf_counter() - _t0
        station_free[win[2]] = t_done
        ev.push(t_done, TX_DONE, a=g, b=sat, d=win[2], f=win[0],
                outcome=outcome)

    if prof is not None:
        prof.begin("event_loop")
    while ev:
        t, i, kind, a, b, _c, d, f = ev.pop()
        if kind == TRAIN:
            if a in queues:
                queues[a].append((t, a))
                try_tx(a, t)
            else:
                r = asg.relays[a]
                ev.push(t + r.time, ISL, a=a, b=r.gateway)
        elif kind == ISL:
            queues[b].append((t, a))
            try_tx(b, t)
        elif kind == TX_START:
            try_tx(a, t)
        else:                               # TX_DONE
            deliveries.append(Delivery(
                sat=b, t_done=t, t_start=t0, gateway=a,
                station=d, hops=hops_of.get(b, 0),
                window=f, **ev.outcomes.pop(i)))
            busy[a] = False
            try_tx(a, t)
    if prof is not None:
        prof.end()
        prof.add_many(("event_loop", "window_fit"), pacc[0], pacc[1])
        prof.add_many(("event_loop", "tx_commit"), pacc[2], pacc[3])

    mask = np.zeros(n, dtype=bool)
    for dlv in deliveries:
        if dlv.delivered:
            mask[dlv.sat] = True
    duration = (max(dlv.t_done for dlv in deliveries) - t0
                if deliveries else sc.max_compute)
    return RoundResult(mask, float(duration), deliveries, scheduled, t0)


# ---------------------------------------------------------------------------
# asynchronous mode
# ---------------------------------------------------------------------------

def run_async_fast(eng, t0: float, msg_bytes: float, n_deliveries: int,
                   max_time: Optional[float] = None):
    """Fast async run: dispatch events sharing a timestamp batch-pop and
    resolve their routes through vectorized window lookups; the route
    chooser reproduces the oracle's ``choose_route`` float-for-float
    (``max(t+isl, rise) + backlog·gs_tx + gs_tx`` elementwise, first
    minimum in BFS order) while honouring intra-batch backlog mutations
    via dirty-row recomputation."""
    from .engine import Delivery

    sc = eng.scenario
    n = sc.walker.n_sats
    trc = _obs_active()
    prof = trc.prof if trc is not None else None
    gs_tx = sc.link.gs_time(msg_bytes)
    # state_build covers the lazily-built shared state (first call pays
    # the BFS topology construction) so it can't pollute the residual
    if prof is not None:
        prof.begin("state_build")
    cache = eng.chan_cache
    fast = eng._fast_state()
    topo = fast.topo
    isl_times = fast.isl_times(msg_bytes)
    if prof is not None:
        prof.end()
    horizon_cap = t0 + (max_time if max_time is not None
                        else 100.0 * sc.lookahead)
    ev = EventQueue()
    if prof is not None:
        prof.begin("round_setup")
    queues: List[list] = [[] for _ in range(n)]
    qlen = np.zeros(n, dtype=np.int64)
    busy = np.zeros(n, dtype=bool)
    wins: List = [None] * n
    mutated = np.zeros(n, dtype=bool)
    station_free: Dict[int, float] = defaultdict(float)
    train_start = np.full(n, float(t0))
    deliveries: List = []

    compute = np.broadcast_to(
        np.asarray(sc.compute_time, dtype=np.float64), (n,))
    ev.push_batch(t0 + compute, TRAIN, np.arange(n))
    if prof is not None:
        prof.end()

    def park(g, t):
        """No usable window for this gateway: re-route the backlog.
        Retries only schedule strictly before the horizon cap (mirrors
        the oracle's guard — a retry at the saturated cap would cycle
        park → retry → park at constant t forever)."""
        if t < horizon_cap:
            for meta in queues[g]:
                ev.push(min(t + sc.lookahead, horizon_cap), RETRY,
                        a=meta[1])
        queues[g].clear()
        qlen[g] = 0
        wins[g] = None
        mutated[g] = True

    # async fires try_tx per event (~10k per mega run): even a counter
    # increment per call shows up against the 1.05x trace-overhead gate,
    # so the fit search is deliberately NOT timed here — its cost reads
    # out as event_loop self time (the sync path, ~100x fewer calls,
    # keeps the exact per-fit timer).  Commits are one per delivery
    # attempt and stay exactly timed.
    pacc = [0, 0.0]              # commit_n, commit_s

    def try_tx(g, t):
        if busy[g] or not queues[g]:
            return
        win = wins[g]
        if win is None or win[1] <= t:
            win = eng.usable_window(g, t)
        fit = False
        for _ in range(64):
            if win is None:
                break
            start = max(t, win[0], station_free[win[2]])
            if start + cache.estimate(g, win, start, msg_bytes,
                                      gs_tx) <= win[1]:
                fit = True
                break
            win = eng.usable_window(g, win[1])
        if not fit:
            park(g, t)
            return
        wins[g] = win
        if start > t:
            ev.push(start, TX_START, a=g)
            return
        meta = queues[g].pop(0)
        qlen[g] -= 1
        busy[g] = True
        mutated[g] = True
        _t0 = perf_counter() if prof is not None else 0.0
        t_done, outcome = cache.commit(g, meta[1], win, t, msg_bytes, gs_tx)
        if prof is not None:
            pacc[0] += 1
            pacc[1] += perf_counter() - _t0
        station_free[win[2]] = t_done
        ev.push(t_done, TX_DONE, a=g, b=meta[1], c=meta[2], d=win[2],
                f=win[0], outcome=outcome)

    def dispatch_batch(sats, t):
        """Route every satellite in one same-timestamp dispatch batch."""
        if prof is not None:
            prof.begin("dispatch")
        b = len(sats)
        ids = topo.ids[sats]                       # (B, C) candidates
        hops = topo.hops[sats]                     # (B, C)
        uniq = np.unique(ids)
        # one vectorized window query per hop distance covers every
        # (candidate, arrival-time) pair the oracle would ask about
        if prof is not None:
            prof.begin("window_query")
        starts = np.empty((len(isl_times), len(uniq)))
        for h in range(len(isl_times)):
            s_h, _, _ = eng.plan.next_windows_for(
                uniq, t + isl_times[h], blocked=eng._blocked)
            starts[h] = s_h
        if prof is not None:
            prof.end()
        pos = np.searchsorted(uniq, ids)
        ws = starts[hops, pos]                     # max(t+isl, rise), (B, C)
        est0 = ws + (qlen[ids] + busy[ids]) * gs_tx + gs_tx
        if topo.valid is not None:
            est0 = np.where(topo.valid[sats], est0, np.inf)
        mutated[:] = False
        any_mut = False
        for j in range(b):
            s = int(sats[j])
            row = ids[j]
            if any_mut and mutated[row].any():
                # an earlier batch member changed a candidate's backlog —
                # recompute this row against live queue state
                est = ws[j] + (qlen[row] + busy[row]) * gs_tx + gs_tx
                if topo.valid is not None:
                    est = np.where(topo.valid[sats[j]], est, np.inf)
            else:
                est = est0[j]
            k = int(np.argmin(est))
            if not np.isfinite(est[k]):
                if t < horizon_cap:
                    ev.push(min(t + sc.lookahead, horizon_cap), RETRY, a=s)
                continue
            gw = int(row[k])
            hp = int(hops[j, k])
            if gw == s:
                queues[s].append((t, s, 0))
                qlen[s] += 1
                mutated[s] = True
                any_mut = True
                try_tx(s, t)
            else:
                ev.push(t + float(isl_times[hp]), ISL, a=s, b=gw, c=hp)
        if prof is not None:
            prof.end()

    n_ok = 0
    if prof is not None:
        prof.begin("event_loop")
    while ev and n_ok < n_deliveries:
        t, i, kind, a, b, c, d, f = ev.pop()
        if t > horizon_cap:
            break
        eng.ensure(t + 2 * sc.lookahead)
        if kind in _DISPATCH:
            batch = [a]
            while True:
                nxt = ev.peek()
                if nxt is None or nxt[0] != t or nxt[2] not in _DISPATCH:
                    break
                batch.append(ev.pop()[3])
            dispatch_batch(np.asarray(batch, dtype=np.int64), t)
        elif kind == ISL:
            queues[b].append((t, a, c))
            qlen[b] += 1
            try_tx(b, t)
        elif kind == TX_START:
            try_tx(a, t)
        else:                               # TX_DONE
            outcome = ev.outcomes.pop(i)
            deliveries.append(Delivery(
                sat=b, t_done=t, t_start=float(train_start[b]), gateway=a,
                station=d, hops=c, window=f, **outcome))
            if outcome["delivered"]:
                n_ok += 1
            busy[a] = False
            mutated[a] = True
            try_tx(a, t)
            # the satellite retrains either way (see the oracle's note)
            train_start[b] = t
            ev.push(t + sc.compute_of(b), TRAIN, a=b)
    if prof is not None:
        prof.end()
        # commits triggered inside dispatch_batch land here too — only
        # the dispatch sub-attribution coarsens
        prof.add_many(("event_loop", "tx_commit"), pacc[0], pacc[1])

    return deliveries
