"""In-orbit aggregation topologies — how updates reach a ground station.

Today's engine uplinks every scheduled update over its own sat→GS link
(possibly after a passive ISL relay hop).  The Razmi et al. line of work
(on-board FL for dense LEO constellations / satellite clusters with ISL)
aggregates *in orbit* instead: updates are partially summed along the
intra-plane ISL ring toward an elected **cluster head**, which uplinks ONE
merged wire per plane — cutting ground-station incast by the plane size.

:func:`make_topology` resolves a scenario's ``topology`` spec into one of

  * ``direct`` — the historical behavior.  The engine's existing sync /
    async paths run untouched, so ``topology="direct"`` is bit-for-bit
    identical to a scenario without the field;
  * ``plane``  — per-orbital-plane convergecast: each plane elects the
    member with the earliest usable GS window as its head, the plane ring
    splits at the head into two arcs, and partial sums flow hop-by-hop
    (each hop costs real ISL time and ``msg_bytes`` wire bytes) until the
    head holds the plane's merged wire and uplinks it through the normal
    window / station-contention / ARQ machinery;
  * ``gossip`` — ``plane`` plus an inter-plane exchange: heads are paired
    (in plane order) and the later-windowed head of each pair ships its
    merged wire over the ISL grid to the earlier-windowed one, which
    uplinks a two-plane wire — halving GS incast again.

Fast-vs-oracle equivalence extends to the new event kinds: the oracle
runs the convergecast as literal heapq events (``agg_train`` /
``agg_forward`` hop arrivals), the fast path computes the identical
arrival times with the same float fold (``max(own, upstream) + hop``
accumulated in arc order — never a closed form like ``ready + k·hop``,
which rounds differently), and both share ONE head-uplink phase
(:func:`_uplink_heads`), parametrized only by whether channel evaluations
go through the memoizing :class:`~repro_torch.sim.fastpath.ChannelCache` (fast)
or the live channel (oracle).  ``tests/test_topology.py`` enforces
bit-identical :class:`~repro_torch.sim.engine.Delivery` timelines across both.

Modeling notes: heads are re-elected every round from the contact plan
(a plane whose members see no usable window within the lookahead skips
the round); aggregation consumes ``(plane_size − 1)`` ISL transfers per
plane (+ the inter-head hops under gossip), accounted in
``RoundResult.bytes_isl``; plane topologies require a regular Walker
grid (``n_sats == n_planes · sats_per_plane``) and the sync engine mode
(FedBuff-style async has no plane-synchronous merge point).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Resolved aggregation topology (see module docstring)."""
    kind: str = "direct"          # "direct" | "plane"
    gossip: bool = False          # plane only: pair heads before uplink

    @property
    def name(self) -> str:
        return "gossip" if self.gossip else self.kind


DIRECT = Topology("direct")
PLANE = Topology("plane")
GOSSIP = Topology("plane", gossip=True)

_BY_NAME = {"direct": DIRECT, "plane": PLANE, "gossip": GOSSIP}


def make_topology(spec) -> Topology:
    """Resolve ``None`` / a name / a :class:`Topology` into a Topology."""
    if spec is None:
        return DIRECT
    if isinstance(spec, Topology):
        return spec
    try:
        return _BY_NAME[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown topology {spec!r}; expected one of "
            f"{sorted(_BY_NAME)} or a Topology instance") from None


def check_plane_compatible(scenario, topology: Topology) -> None:
    """Plane topologies need a regular Walker grid: head election and the
    arc split assume every plane holds exactly ``sats_per_plane``
    members."""
    if topology.kind == "direct":
        return
    w = scenario.walker
    spp = w.sats_per_plane
    if spp < 1 or spp * w.n_planes != w.n_sats:
        raise ValueError(
            f"topology '{topology.name}' needs a regular constellation "
            f"(n_sats == n_planes * sats_per_plane); got n_sats="
            f"{w.n_sats}, n_planes={w.n_planes}")


# ---------------------------------------------------------------------------
# per-round plan: election, arcs, gossip pairing — shared by both engines
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanePlan:
    """Deterministic per-round aggregation plan (pure function of the
    contact plan + t0, so fast and oracle compute the identical plan)."""
    heads: Dict[int, int]               # plane -> head sat
    arcs: Dict[int, Tuple[List[int], List[int]]]  # head -> (up, down) far→near
    uplinkers: List[int]                # heads that perform a GS uplink
    merged: Dict[int, Tuple[int, ...]]  # uplinker -> every sat its wire sums
    pairs: List[Tuple[int, int, int]]   # (primary, secondary, isl hops)
    hops_of: Dict[int, int]             # uplinker -> max ISL hops travelled


def _plane_arcs(head: int, plane: int, spp: int) -> Tuple[List[int], List[int]]:
    """Split the plane ring at the head into two convergecast arcs.

    Members at ring offset ``o = (slot − head_slot) mod spp`` with
    ``1 ≤ o ≤ spp//2`` feed the *up* arc (distance ``o``); the rest feed
    the *down* arc (distance ``spp − o``) — ties at exactly half the ring
    go up, so the split is canonical.  Each arc lists sats far→near."""
    base = plane * spp
    hs = head - base
    up = [base + (hs + o) % spp for o in range(spp // 2, 0, -1)]
    down = [base + (hs + o) % spp for o in range(spp // 2 + 1, spp)]
    return up, down


def _ring_dist(a: int, b: int, n: int) -> int:
    d = abs(a - b) % n
    return min(d, n - d)


def plan_plane_round(eng, t0: float) -> PlanePlan:
    """Elect heads and lay out the round's aggregation plan.

    Head election: per plane, the member with the earliest usable GS
    window after its training completes (``t0 + compute``), ties broken
    by lowest sat id; members whose earliest window rises past
    ``t0 + lookahead`` are ineligible (mirrors the direct scheduler's
    horizon), and a plane with no eligible member skips the round."""
    sc = eng.scenario
    w = sc.walker
    spp = w.sats_per_plane
    n = w.n_sats
    t_ready = t0 + np.broadcast_to(
        np.asarray(sc.compute_time, dtype=np.float64), (n,))
    starts, _, _ = eng.usable_windows_all(t_ready)
    elig = np.isfinite(starts) & (starts <= t0 + sc.lookahead)
    heads: Dict[int, int] = {}
    head_start: Dict[int, float] = {}
    arcs: Dict[int, Tuple[List[int], List[int]]] = {}
    for p in range(w.n_planes):
        members = np.arange(p * spp, (p + 1) * spp)
        ok = elig[members]
        if not ok.any():
            continue                       # plane dark this round
        cand_starts = np.where(ok, starts[members], np.inf)
        head = int(members[int(np.argmin(cand_starts))])  # first min = low id
        heads[p] = head
        head_start[head] = float(starts[head])
        arcs[head] = _plane_arcs(head, p, spp)
    merged: Dict[int, Tuple[int, ...]] = {}
    hops_of: Dict[int, int] = {}
    for p, h in heads.items():
        merged[h] = tuple(range(p * spp, (p + 1) * spp))
        hops_of[h] = max(spp // 2, spp - 1 - spp // 2)   # ring radius
    pairs: List[Tuple[int, int, int]] = []
    uplinkers = [heads[p] for p in sorted(heads)]
    if eng.topology.gossip and len(uplinkers) > 1:
        planes = sorted(heads)
        uplinkers = []
        for i in range(0, len(planes) - 1, 2):
            pa, pb = planes[i], planes[i + 1]
            ha, hb = heads[pa], heads[pb]
            # earlier elected window uplinks; tie → the lower plane
            if (head_start[hb], pb) < (head_start[ha], pa):
                pri, sec, pp, sp = hb, ha, pb, pa
            else:
                pri, sec, pp, sp = ha, hb, pa, pb
            hops = (_ring_dist(pp, sp, w.n_planes)
                    + _ring_dist(pri % spp, sec % spp, spp))
            pairs.append((pri, sec, hops))
            merged[pri] = merged[pri] + merged.pop(sec)
            hops_of[pri] = max(hops_of[pri], hops_of.pop(sec) + hops)
            uplinkers.append(pri)
        if len(planes) % 2:
            uplinkers.append(heads[planes[-1]])
        uplinkers.sort()
    return PlanePlan(heads=heads, arcs=arcs, uplinkers=uplinkers,
                     merged=merged, pairs=pairs, hops_of=hops_of)


def _plan_isl_transfers(plan: PlanePlan) -> int:
    """Number of msg-sized ISL transfers the plan performs: one per
    non-head member (convergecast) plus the inter-head gossip hops."""
    n = sum(len(up) + len(down) for up, down in plan.arcs.values())
    n += sum(hops for _, _, hops in plan.pairs)
    return n


# ---------------------------------------------------------------------------
# aggregation timing — oracle event machine vs. fast fold
# ---------------------------------------------------------------------------
# Both compute, for every uplinking head, the instant its merged wire is
# complete.  The float arithmetic must agree bit-for-bit: each hop is the
# fold  forward = max(own_ready, upstream_arrival); arrival = forward +
# hop_time  accumulated in arc order, and the head's readiness is a pure
# max over (own train, arc arrivals, gossip arrivals) — max is exact, so
# only the identical + accumulation matters.

def _arc_arrival_fold(chain: List[int], ready: np.ndarray, hop: float
                      ) -> float:
    """Arrival time of a convergecast arc's partial sum at the head."""
    arr = -np.inf
    for s in chain:                        # far → near
        arr = max(float(ready[s]), arr) + hop
    return arr


def agg_ready_fast(eng, plan: PlanePlan, t0: float, msg_bytes: float
                   ) -> List[Tuple[int, float]]:
    """Per-uplinker readiness times via the direct fold (fast path)."""
    sc = eng.scenario
    n = sc.walker.n_sats
    ready = t0 + np.broadcast_to(
        np.asarray(sc.compute_time, dtype=np.float64), (n,))
    hop = sc.link.isl_time(msg_bytes, hops=1)
    head_ready: Dict[int, float] = {}
    for h, (up, down) in plan.arcs.items():
        t = float(ready[h])
        for chain in (up, down):
            if chain:
                t = max(t, _arc_arrival_fold(chain, ready, hop))
        head_ready[h] = t
    for pri, sec, hops in plan.pairs:
        arr = head_ready[sec] + sc.link.isl_time(msg_bytes, hops=hops)
        head_ready[pri] = max(head_ready[pri], arr)
    return [(h, head_ready[h]) for h in plan.uplinkers]


def agg_ready_oracle(eng, plan: PlanePlan, t0: float, msg_bytes: float
                     ) -> List[Tuple[int, float]]:
    """Per-uplinker readiness times via a literal heapq event machine:
    ``agg_train`` (a member finished local training) and ``agg_forward``
    (a partial sum crossed one ISL hop).  A member forwards as soon as
    it holds both its own update and its upstream partial sum; the event
    arithmetic is the same ``max(own, upstream) + hop`` the fast fold
    uses, so the timelines agree bit-for-bit."""
    sc = eng.scenario
    hop = sc.link.isl_time(msg_bytes, hops=1)
    q: list = []
    seq = itertools.count()

    def push(t, kind, **kw):
        heapq.heappush(q, (t, next(seq), kind, kw))

    own: Dict[int, float] = {}             # sat -> train-done time
    upstream: Dict[int, float] = {}        # sat -> upstream arrival time
    downstream: Dict[int, Optional[int]] = {}
    participants: List[int] = []
    arc_arrival: Dict[int, List[float]] = {h: [] for h in plan.arcs}
    n_arcs: Dict[int, int] = {}
    head_of: Dict[int, int] = {}
    for h, (up, down) in plan.arcs.items():
        participants.append(h)
        head_of[h] = h
        n_arcs[h] = (1 if up else 0) + (1 if down else 0)
        for chain in (up, down):
            for i, s in enumerate(chain):
                participants.append(s)
                head_of[s] = h
                downstream[s] = chain[i + 1] if i + 1 < len(chain) else None
                if i == 0:
                    upstream[s] = -np.inf  # arc tip: nothing upstream
    for s in participants:
        push(t0 + sc.compute_of(s), "agg_train", sat=s)

    head_ready: Dict[int, float] = {}
    pending: Dict[int, int] = dict(n_arcs)

    def maybe_forward(s):
        if s in own and s in upstream:
            fwd = max(own[s], upstream[s])
            nxt = downstream[s]
            if nxt is None:
                push(fwd + hop, "agg_forward", sat=head_of[s], arc_tail=s)
            else:
                push(fwd + hop, "agg_forward", sat=nxt, arc_tail=None)
            del upstream[s]                # forward exactly once

    def maybe_ready(h):
        if h in own and pending[h] == 0 and h not in head_ready:
            t = own[h]
            for a in arc_arrival[h]:
                t = max(t, a)
            head_ready[h] = t

    while q:
        t, _, kind, kw = heapq.heappop(q)
        s = kw["sat"]
        if kind == "agg_train":
            own[s] = t
            if s in plan.arcs:
                maybe_ready(s)
            else:
                maybe_forward(s)
        else:                              # agg_forward
            if kw["arc_tail"] is not None or s in plan.arcs:
                # the hop landed at the head: one arc complete
                arc_arrival[s].append(t)
                pending[s] -= 1
                maybe_ready(s)
            else:
                upstream[s] = t
                maybe_forward(s)

    for pri, sec, hops in plan.pairs:
        arr = head_ready[sec] + sc.link.isl_time(msg_bytes, hops=hops)
        head_ready[pri] = max(head_ready[pri], arr)
    return [(h, head_ready[h]) for h in plan.uplinkers]


# ---------------------------------------------------------------------------
# head uplink phase — ONE implementation for both engines
# ---------------------------------------------------------------------------

def _uplink_heads(eng, ready: List[Tuple[int, float]], msg_bytes: float,
                  use_cache: bool) -> List[tuple]:
    """Uplink each head's merged wire through the standard machinery:
    64-iteration window refit, per-station serialization, and the lossy
    channel's ARQ.  ``use_cache`` routes estimates/commits through the
    engine's :class:`~repro_torch.sim.fastpath.ChannelCache` (fast path) or the
    live channel (oracle) — the cache's acceptance contract is that both
    produce the identical floats.

    Returns ``(head, t_done, station, win_rise, outcome)`` tuples in
    completion order; heads with no fitting window this round drop out
    (no record — mirrors the direct path's undeliverable satellites)."""
    sc = eng.scenario
    gs_tx = sc.link.gs_time(msg_bytes)
    if use_cache:
        cache = eng.chan_cache
        est, commit = cache.estimate, cache.commit
    else:
        est, commit = eng.tx_estimate, eng.tx_commit
    q: list = []
    seq = itertools.count()

    def push(t, kind, **kw):
        heapq.heappush(q, (t, next(seq), kind, kw))

    station_free: Dict[int, float] = defaultdict(float)
    wins: Dict[int, object] = {}
    done: List[tuple] = []
    for h, t in ready:                     # plane order — canonical seq ties
        push(t, "head_ready", head=h)

    def try_tx(h, t):
        win = wins.get(h)
        if win is None or win[1] <= t:
            win = eng.usable_window(h, t)
        for _ in range(64):
            if win is None:
                wins[h] = None
                return                     # undeliverable this round
            start = max(t, win[0], station_free[win[2]])
            if start + est(h, win, start, msg_bytes, gs_tx) <= win[1]:
                break
            win = eng.usable_window(h, win[1])
        else:
            wins[h] = None
            return
        wins[h] = win
        if start > t:
            push(start, "tx_start", head=h)
            return
        t_done, outcome = commit(h, h, win, t, msg_bytes, gs_tx)
        station_free[win[2]] = t_done
        push(t_done, "tx_done", head=h, station=win[2], win_rise=win[0],
             outcome=outcome)

    while q:
        t, _, kind, kw = heapq.heappop(q)
        if kind == "tx_done":
            done.append((kw["head"], t, kw["station"], kw["win_rise"],
                         kw["outcome"]))
        else:                              # head_ready / tx_start
            try_tx(kw["head"], t)
    return done


# ---------------------------------------------------------------------------
# cluster-head failure + timeout-triggered failover (repro_torch.faults)
# ---------------------------------------------------------------------------

def _apply_head_failures(eng, plan: PlanePlan, ready: List[Tuple[int, float]],
                         t0: float, msg_bytes: float):
    """Inject cluster-head failures mid-convergecast and fail over.

    ONE shared implementation consumed after either engine's aggregation
    timing (:func:`agg_ready_fast` / :func:`agg_ready_oracle`), so the
    failover timeline is bit-identical across engines by construction.
    The failure draw is keyed on ``(plane, bits(t0))`` (see
    :mod:`repro_torch.faults.process`); a firing head fails at
    ``t_f = t0 + frac · (t_ready − t0)``.

    Salvage granularity is the convergecast *arc*: each arc's partial sum
    arrives at the head as one message, so an arc whose arrival precedes
    ``t_f`` was already absorbed by the dead head (its members' updates
    are lost with it), while an arc still in flight is held at its
    near-most member and can be re-routed.  After a ``failover_timeout``
    detection delay the surviving members re-elect a head (same criterion
    as the original election — earliest usable GS window, ties to the low
    sat id, lookahead horizon) and surviving partials forward
    ``ring-distance`` extra ISL hops to it; the new head uplinks the
    partial plane sum.  No eligible survivor → the plane skips the round.

    EF semantics: the failed head *crashed* (residual LOST — marked in
    ``crashed``); absorbed-arc members and stranded survivors are alive
    and merely lost their in-flight updates (*erasure*: residual kept,
    marked in ``aborted`` so the runner counts them attempted-but-lost).

    Returns ``(ready', extra_isl_transfers, failover_events, crashed,
    aborted)`` and updates ``plan`` (uplinkers / merged / hops_of) in
    place; with no firing draw everything passes through unchanged.
    """
    sc = eng.scenario
    fm = eng.faults
    w = sc.walker
    spp = w.sats_per_plane
    n = w.n_sats
    ready_vec = t0 + np.broadcast_to(
        np.asarray(sc.compute_time, dtype=np.float64), (n,))
    hop = sc.link.isl_time(msg_bytes, hops=1)
    crashed = np.zeros(n, dtype=bool)
    aborted = np.zeros(n, dtype=bool)
    events: List[dict] = []
    extra_transfers = 0
    out_ready: List[Tuple[int, float]] = []
    for h, t_ready in ready:
        p = h // spp
        frac = fm.head_failure(eng.seed, p, t0)
        if frac is None:
            out_ready.append((h, t_ready))
            continue
        t_f = t0 + frac * max(t_ready - t0, 0.0)
        t_detect = t_f + fm.failover_timeout
        up, down = plan.arcs[h]
        lost = [h]
        surv_arcs: List[Tuple[List[int], float]] = []
        for chain in (up, down):
            if not chain:
                continue
            arr = _arc_arrival_fold(chain, ready_vec, hop)
            if arr <= t_f:
                lost.extend(chain)         # absorbed by the dead head
            else:
                surv_arcs.append((chain, arr))
        crashed[h] = True
        aborted[lost] = True
        survivors = [s for chain, _ in surv_arcs for s in chain]
        new_head = None
        if survivors:
            best = None
            for s in sorted(survivors):
                win = eng.usable_window(s, max(float(ready_vec[s]),
                                               t_detect))
                if win is None or win[0] > t0 + sc.lookahead:
                    continue
                key = (win[0], s)
                if best is None or key < best[0]:
                    best = (key, s)
            if best is not None:
                new_head = best[1]
        if new_head is None:
            # nobody can take over inside the horizon: the plane skips
            # the round; stranded survivors keep their residuals (erasure)
            aborted[survivors] = True
            plan.uplinkers.remove(h)
            del plan.merged[h]
            plan.hops_of.pop(h, None)
            events.append(dict(plane=int(p), head=int(h), new_head=None,
                               t_fail=float(t_f), t_detect=float(t_detect),
                               n_lost=len(lost), n_salvaged=0,
                               extra_hops=0))
            continue
        t_new = t_detect
        extra = 0
        max_d = 0
        for chain, arr in surv_arcs:
            near = chain[-1]               # holds the in-flight partial
            d = _ring_dist(near - p * spp, new_head - p * spp, spp)
            t_new = max(t_new, max(arr, t_detect) + d * hop)
            extra += d
            max_d = max(max_d, d)
        extra_transfers += extra
        plan.uplinkers[plan.uplinkers.index(h)] = new_head
        plan.merged[new_head] = tuple(sorted(survivors))
        del plan.merged[h]
        plan.hops_of[new_head] = plan.hops_of.pop(h) + max_d
        events.append(dict(plane=int(p), head=int(h), new_head=int(new_head),
                           t_fail=float(t_f), t_detect=float(t_detect),
                           n_lost=len(lost), n_salvaged=len(survivors),
                           extra_hops=int(extra)))
        out_ready.append((new_head, float(t_new)))
    if not events:
        return ready, 0, None, None, None
    return out_ready, extra_transfers, events, crashed, aborted


# ---------------------------------------------------------------------------
# round driver
# ---------------------------------------------------------------------------

def run_round_plane(eng, t0: float, msg_bytes: float):
    """One synchronous plane-aggregated round (both engines; the fast /
    oracle split lives in the aggregation timing + channel evaluation,
    see module docstring)."""
    from .engine import Delivery, RoundResult

    sc = eng.scenario
    eng.ensure(t0 + 2 * sc.lookahead)
    plan = plan_plane_round(eng, t0)
    n = sc.walker.n_sats
    scheduled = np.zeros(n, dtype=bool)
    for members in plan.merged.values():
        scheduled[list(members)] = True
    bytes_isl = _plan_isl_transfers(plan) * msg_bytes
    if not plan.uplinkers:
        return RoundResult(np.zeros(n, dtype=bool), sc.max_compute, [],
                           scheduled, t0, bytes_isl=0.0, merged={},
                           heads=dict(plan.heads))
    if eng.fast:
        ready = agg_ready_fast(eng, plan, t0, msg_bytes)
    else:
        ready = agg_ready_oracle(eng, plan, t0, msg_bytes)
    failovers = crashed = aborted = None
    fm = getattr(eng, "faults", None)
    if fm is not None and fm.head_enabled:
        ready, extra_isl, failovers, crashed, aborted = \
            _apply_head_failures(eng, plan, ready, t0, msg_bytes)
        bytes_isl += extra_isl * msg_bytes
    done = _uplink_heads(eng, ready, msg_bytes, use_cache=eng.fast)
    deliveries = [
        Delivery(sat=h, t_done=td, t_start=t0, gateway=h, station=stn,
                 hops=plan.hops_of[h], window=rise, **outcome)
        for h, td, stn, rise, outcome in done]
    mask = np.zeros(n, dtype=bool)
    for d in deliveries:
        if d.delivered:
            mask[list(plan.merged[d.sat])] = True
    duration = (max(d.t_done for d in deliveries) - t0
                if deliveries else sc.max_compute)
    return RoundResult(mask, float(duration), deliveries, scheduled, t0,
                       bytes_isl=float(bytes_isl),
                       merged=dict(plan.merged), heads=dict(plan.heads),
                       crashed=crashed, aborted=aborted, failovers=failovers)
