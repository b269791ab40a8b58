"""Discrete-event constellation simulation engine.

A single heapq event queue drives per-satellite state machines through the
phases  train → (ISL relay) → wait-for-window → uplink.  The engine is
pure simulation substrate: it produces a timeline of :class:`Delivery`
records (which satellite's update landed at which ground station, when);
the federated-learning algebra lives in :class:`repro_torch.core.fedlt_sat`.

Two operating modes:

  * :meth:`Engine.run_round` — synchronous: a scheduling policy picks the
    round's gateways + relays (see ``constellation.scheduler.Scheduler``),
    the engine executes the plan event-by-event (GS-link serialization,
    per-station contention, link dropout, heterogeneous compute times) and
    returns when the last scheduled update lands.
  * :meth:`Engine.run_async` — asynchronous: every satellite trains
    continuously; on finishing it routes its update to the satellite with
    the best estimated delivery (itself, or a multi-hop ISL forward) and
    immediately retrains once the update is delivered.  Feeds FedBuff-style
    buffered aggregation.

Event kinds: ``train_done``, ``isl_arrive``, ``tx_start`` (link-free /
window-open wakeup), ``tx_done``, ``retry`` (async: no window anywhere,
try again later).

``msg_bytes`` is the measured on-wire size of one update — callers with a
wire codec pass ``WireMessage.nbytes`` (see :mod:`repro_torch.wire`), so every
transmission time and each :class:`Delivery`'s ``nbytes`` record derive
from actual encoded bytes, not nominal estimates.

All timing is host-side numpy/python — device compute stays in the
federated core.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..constellation.links import LinkModel
from ..constellation.orbits import GroundStation, Walker
from ..obs.trace import active as _obs_active
from .contacts import ContactPlan
from .routing import Router


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """A complete simulation setting — constellation, stations, links,
    per-satellite compute, weather, and (optionally) a stochastic lossy
    channel (:class:`repro_torch.channel.ChannelModel`)."""
    name: str = "walker-kiruna"
    walker: Walker = Walker()
    stations: Tuple[GroundStation, ...] = (GroundStation(),)
    link: LinkModel = LinkModel()
    compute_time: Union[float, np.ndarray] = 30.0  # scalar or (S,) seconds
    dropout: float = 0.0        # P(a contact window is weather-blocked)
    k_direct: int = 4
    n_relay: int = 2
    max_hops: int = 4
    lookahead: float = 7200.0   # scheduling horizon per round
    dt: float = 10.0            # contact-plan grid resolution
    channel: Optional[object] = None  # repro_torch.channel.ChannelModel or None
    # how updates reach the ground (repro_torch.sim.topology): None ≡ "direct"
    # (per-satellite uplinks, the historical behavior), "plane" (per-plane
    # convergecast to an elected cluster head), "gossip" (plane + paired
    # inter-head merge) or a Topology instance
    topology: Optional[object] = None
    # node-level fault injection (repro_torch.faults.FaultModel): satellite
    # crash/reboot, ground-station blackouts, cluster-head failure
    faults: Optional[object] = None

    def compute_of(self, sat: int) -> float:
        if np.ndim(self.compute_time) == 0:
            return float(self.compute_time)
        return float(np.asarray(self.compute_time)[sat])

    @property
    def max_compute(self) -> float:
        return float(np.max(self.compute_time))


@dataclasses.dataclass
class Delivery:
    sat: int            # whose update landed
    t_done: float       # delivery completion time
    t_start: float      # when that satellite started training the update
    gateway: int        # satellite that performed the GS uplink
    station: int        # ground-station index
    hops: int           # ISL hops travelled
    nbytes: float = 0.0  # payload bytes usefully delivered (0 on failure)
    window: float = float("nan")  # rise time of the contact window used
    # lossy-channel accounting (== nbytes / 0 / True without a channel):
    nbytes_attempted: float = 0.0  # bytes put on the air, retx included
    retries: int = 0               # ARQ rounds beyond the first
    delivered: bool = True         # all segments landed (False: lost/truncated)

    def to_dict(self) -> dict:
        """JSON-stable serialization (the tracer's delivery record).

        Every field maps to a plain python scalar; the one NaN-able field
        (``window``, NaN on records predating the window tagging) maps to
        ``None`` so the output survives strict JSON round-trips
        (:meth:`from_dict` restores the NaN)."""
        w = self.window
        return {"sat": int(self.sat), "t_done": float(self.t_done),
                "t_start": float(self.t_start),
                "gateway": int(self.gateway), "station": int(self.station),
                "hops": int(self.hops), "nbytes": float(self.nbytes),
                "window": float(w) if w == w else None,
                "nbytes_attempted": float(self.nbytes_attempted),
                "retries": int(self.retries),
                "delivered": bool(self.delivered)}

    @classmethod
    def from_dict(cls, d: dict) -> "Delivery":
        w = d["window"]
        return cls(sat=d["sat"], t_done=d["t_done"], t_start=d["t_start"],
                   gateway=d["gateway"], station=d["station"],
                   hops=d["hops"], nbytes=d["nbytes"],
                   window=float("nan") if w is None else w,
                   nbytes_attempted=d["nbytes_attempted"],
                   retries=d["retries"], delivered=d["delivered"])


@dataclasses.dataclass
class Cohort:
    """Deliveries sharing one (station, contact window): the unit at which
    uplink compression work batches.

    Every update that crosses the same ground-station window is, at the
    receiving end, one contiguous burst — so the compress→EF→pack chain
    for a cohort's satellites runs as ONE stacked kernel dispatch
    (:mod:`repro_torch.kernels.compress_pipeline`) instead of one chain per
    satellite.  See ``SpaceRunner(measure="cohort")``.
    """

    station: int
    window: float               # rise time of the shared contact window
    sats: List[int]             # delivery order within the window
    deliveries: List[Delivery]

    @property
    def t_first(self) -> float:
        return self.deliveries[0].t_done

    @property
    def t_last(self) -> float:
        return self.deliveries[-1].t_done


def group_cohorts(deliveries: Sequence[Delivery]) -> List["Cohort"]:
    """Group deliveries into per-(station, contact-window) cohorts, ordered
    by first delivery time.  Deliveries predating the ``window`` field
    (NaN) each form a singleton cohort."""
    groups: Dict[tuple, Cohort] = {}
    for i, d in enumerate(deliveries):
        key = (d.station, d.window) if d.window == d.window else ("?", i)
        c = groups.get(key)
        if c is None:
            groups[key] = Cohort(d.station, d.window, [d.sat], [d])
        else:
            c.sats.append(d.sat)
            c.deliveries.append(d)
    return sorted(groups.values(), key=lambda c: c.t_first)


@dataclasses.dataclass
class RoundResult:
    mask: np.ndarray            # bool (S,) — updates actually delivered
    duration: float
    deliveries: List[Delivery]
    scheduled: np.ndarray       # bool (S,) — what the policy planned
    t0: float = 0.0
    # in-orbit aggregation (repro_torch.sim.topology) — direct rounds keep the
    # defaults, so their serialization and downstream accounting are
    # unchanged:
    bytes_isl: float = 0.0      # wire bytes spent on ISL hops this round
    # uplinking head -> every satellite its merged wire sums (None: direct)
    merged: Optional[Dict[int, Tuple[int, ...]]] = None
    heads: Optional[Dict[int, int]] = None   # plane -> elected head
    # fault injection (repro_torch.faults) — None on fault-free rounds:
    crashed: Optional[np.ndarray] = None   # bool (S,) — sats whose memory
    #                                        (EF residual) was wiped
    aborted: Optional[np.ndarray] = None   # bool (S,) — updates destroyed
    #                                        in-orbit with no delivery record
    faults: Optional[List[dict]] = None       # `fault` event records
    failovers: Optional[List[dict]] = None    # `head_failover` event records

    def cohorts(self) -> List[Cohort]:
        """Per-(station, contact-window) delivery cohorts (see
        :class:`Cohort`)."""
        return group_cohorts(self.deliveries)

    def to_dict(self) -> dict:
        """JSON-stable serialization: masks as bool lists, deliveries via
        :meth:`Delivery.to_dict` (round-trips through :meth:`from_dict`).
        Aggregation fields only appear on plane-topology rounds, so direct
        rounds serialize exactly as they always have."""
        out = {"mask": [bool(b) for b in self.mask],
               "duration": float(self.duration),
               "deliveries": [d.to_dict() for d in self.deliveries],
               "scheduled": [bool(b) for b in self.scheduled],
               "t0": float(self.t0)}
        if self.merged is not None:
            out["bytes_isl"] = float(self.bytes_isl)
            out["merged"] = {str(h): [int(s) for s in ms]
                             for h, ms in self.merged.items()}
            out["heads"] = {str(p): int(h)
                            for p, h in (self.heads or {}).items()}
        if self.crashed is not None:
            out["crashed"] = [bool(b) for b in self.crashed]
        if self.aborted is not None:
            out["aborted"] = [bool(b) for b in self.aborted]
        if self.faults:
            out["faults"] = [dict(ev) for ev in self.faults]
        if self.failovers:
            out["failovers"] = [dict(ev) for ev in self.failovers]
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "RoundResult":
        merged = d.get("merged")
        return cls(mask=np.asarray(d["mask"], dtype=bool),
                   duration=d["duration"],
                   deliveries=[Delivery.from_dict(x)
                               for x in d["deliveries"]],
                   scheduled=np.asarray(d["scheduled"], dtype=bool),
                   t0=d["t0"],
                   bytes_isl=d.get("bytes_isl", 0.0),
                   merged=None if merged is None else {
                       int(h): tuple(ms) for h, ms in merged.items()},
                   heads=None if merged is None else {
                       int(p): int(h)
                       for p, h in d.get("heads", {}).items()},
                   crashed=(None if "crashed" not in d else
                            np.asarray(d["crashed"], dtype=bool)),
                   aborted=(None if "aborted" not in d else
                            np.asarray(d["aborted"], dtype=bool)),
                   faults=d.get("faults"),
                   failovers=d.get("failovers"))


# ---------------------------------------------------------------------------
# trace emission (repro_torch.obs)
# ---------------------------------------------------------------------------
# Emission happens HERE, in the run_round/run_async wrappers, after the
# engine (fast batch core or heapq oracle) has produced its result: both
# paths therefore emit the identical record schema from the identical
# Delivery timeline, which is what lets `python -m repro.obs diff`
# localize the first fast-vs-oracle divergence.  The hot event loops are
# untouched — with no active tracer the only cost is one module
# attribute read per round.

def _emit_deliveries(trc, deliveries: Sequence[Delivery], **tags) -> tuple:
    """Emit the delivery records (``Delivery.to_dict()`` plus ``kind`` and
    ``tags``) and their ``arq`` events, and bump the byte, delivery and
    latency metrics: each cell takes its deliveries' values in delivery
    order, so its sum is that of one ``add`` per delivery, bit for bit.
    Returns (bytes put on the air, deliveries that landed)."""
    mtr = trc.metrics
    lat = mtr.histogram("delivery_latency", lo=0.0)
    air_c = mtr.counter("bytes_air")
    retx_c = mtr.counter("bytes_retx")
    dlv_c = mtr.counter("deliveries")
    air, status = {}, {}
    retx, lats = [], []
    bytes_air = 0.0
    n_ok = 0
    for d in deliveries:
        rec = d.to_dict()
        rec["kind"] = "delivery"
        rec.update(tags)
        trc.raw(rec)
        att, ok = d.nbytes_attempted, d.delivered
        bytes_air += att
        n_ok += bool(ok)
        air.setdefault(d.station, []).append(att)
        retx.append(att - d.nbytes)
        st = "ok" if ok else "lost"
        status[st] = status.get(st, 0) + 1
        lats.append(d.t_done - d.t_start)
        if d.retries or not ok:
            trc.event("arq", **tags, sat=rec["sat"], gateway=rec["gateway"],
                      station=rec["station"], window=rec["window"],
                      retries=rec["retries"], delivered=rec["delivered"],
                      nbytes_attempted=rec["nbytes_attempted"], t_done=rec["t_done"])
    for station, values in air.items():
        air_c.add_each(values, station=station)
    retx_c.add_each(retx)
    for st, n in status.items():
        dlv_c.add_each([1.0] * n, status=st)
    lat.observe_each(lats)
    return bytes_air, n_ok


def _emit_round_trace(trc, res: "RoundResult", engine: str, k: int) -> None:
    """Emit one sync round's records (kinds: delivery/arq/cohort/round)
    and bump the byte/latency metrics."""
    mtr = trc.metrics
    bytes_air, n_ok = _emit_deliveries(trc, res.deliveries, round=k)
    n_lost = len(res.deliveries) - n_ok
    for c in res.cohorts():
        w = c.window
        trc.event("cohort", round=k, station=int(c.station),
                  window=float(w) if w == w else None,
                  n_sats=len(c.sats), t_first=float(c.t_first),
                  t_last=float(c.t_last),
                  nbytes=float(sum(d.nbytes for d in c.deliveries)))
    if res.deliveries:
        mtr.histogram("lost_frac", lo=0.0).observe(
            n_lost / len(res.deliveries))
    # n_delivered counts delivered *wires* (delivery records), which for
    # direct rounds equals mask.sum() — each scheduled satellite uplinks
    # at most once — and for plane rounds counts head uplinks, keeping
    # the check() count invariant engine-agnostic; the member count rides
    # on the plane extras below
    extra = {}
    if res.merged is not None:
        extra = dict(topology="plane", bytes_isl=float(res.bytes_isl),
                     n_members_delivered=int(res.mask.sum()))
    trc.event("round", round=k, t0=float(res.t0),
              duration=float(res.duration),
              n_scheduled=int(res.scheduled.sum()),
              n_delivered=n_ok, n_lost=n_lost,
              bytes_air=bytes_air, engine=engine, **extra)
    trc.series("bytes_air", k, bytes_air)
    if res.deliveries:
        trc.series("lost_frac_air", k, n_lost / len(res.deliveries))
    if res.merged is not None:
        # plane-topology extras: the ISL/GS byte split plus one election
        # record per plane with a head — deterministic plan output, so
        # fast and oracle traces agree (head_elect is a DIFF kind)
        mtr.counter("bytes_isl").add(float(res.bytes_isl))
        trc.series("bytes_isl", k, float(res.bytes_isl))
        trc.series("bytes_gs", k, bytes_air)
        uplinker_of = {s: h for h, ms in res.merged.items() for s in ms}
        for p in sorted(res.heads or {}):
            h = res.heads[p]
            trc.event("head_elect", round=k, plane=int(p), head=int(h),
                      uplinker=int(uplinker_of.get(h, h)),
                      n_merged=len(res.merged.get(
                          uplinker_of.get(h, h), ())))
    # fault injection (repro_torch.faults): both engines run the identical
    # shared post-filter, so these streams are DIFF kinds like delivery
    for ev in res.faults or ():
        trc.event("fault", round=k, **ev)
        mtr.counter("faults").add(1.0, what=ev.get("what", "?"))
    for ev in res.failovers or ():
        trc.event("head_failover", round=k, **ev)
        mtr.counter("faults").add(1.0, what="head_failure")


def _emit_async_trace(trc, deliveries: Sequence[Delivery], engine: str,
                      run: int, t0: float, n_requested: int,
                      fault_events: Sequence[dict] = ()) -> None:
    """Emit one async run's records: per-delivery (``round=None``,
    tagged with the run index) plus a closing ``async_run`` summary."""
    mtr = trc.metrics
    bytes_air, n_ok = _emit_deliveries(trc, deliveries, round=None, run=run)
    for ev in fault_events:
        trc.event("fault", round=None, run=run, **ev)
        mtr.counter("faults").add(1.0, what=ev.get("what", "?"))
    t_end = max((d.t_done for d in deliveries), default=t0)
    trc.event("async_run", run=run, t0=float(t0),
              n_requested=int(n_requested), n_deliveries=len(deliveries),
              n_ok=n_ok, n_lost=len(deliveries) - n_ok,
              bytes_air=bytes_air, t_end=float(t_end), engine=engine)
    # async curves get their own names: a trace mixing sync rounds and
    # async runs would otherwise collide on the step axis
    trc.series("async_bytes_air", run, bytes_air)
    if deliveries:
        trc.series("async_lost_frac", run,
                   (len(deliveries) - n_ok) / len(deliveries))


def _check_faults_compatible(faults, topology) -> None:
    """Head-failure injection needs the plane convergecast's failover
    machinery; the gossip pair-merge has no re-election analogue yet."""
    if (faults is not None and getattr(faults, "head_enabled", False)
            and getattr(topology, "gossip", False)):
        raise ValueError(
            "head_failure_rate > 0 supports topology='direct'/'plane' "
            "only — gossip pair-merge failover is not modeled "
            f"(topology={topology.name!r})")


def _apply_sync_faults(eng: "Engine", res: RoundResult) -> RoundResult:
    """Shared satellite-crash post-filter for sync rounds (both engines).

    Runs AFTER either engine produced its (bit-identical) result, so the
    fault timeline is bit-identical by construction.  Crash draws are
    keyed on (sat, bits(t_start)) — see :mod:`repro_torch.faults.process`.

    * direct rounds: an upset during a flight ``[t_start, t_done]``
      destroys the in-flight update — the delivery flips to lost.
    * plane rounds: an upset during a *member's* local training destroys
      its contribution before it enters the plane sum (the merged wire
      still flies, one slot lighter); uplinking heads are handled by the
      head-failover machinery in :mod:`repro_torch.sim.topology` instead.

    Either way the crashed sat reboots with wiped memory: ``res.crashed``
    marks it for the EF residual re-sync in
    :class:`repro_torch.core.fedlt_sat.SpaceRunner` (residual LOST — unlike an
    erasure, where the residual is kept and telescopes forward).
    """
    fm = eng.faults
    events: List[dict] = []
    crashed = (res.crashed.copy() if res.crashed is not None
               else np.zeros(len(res.mask), dtype=bool))
    mask = res.mask
    deliveries = res.deliveries
    if res.merged is None:
        if deliveries:
            sats = np.array([d.sat for d in deliveries], dtype=np.int64)
            t_s = np.array([d.t_start for d in deliveries])
            exp = np.array([d.t_done for d in deliveries]) - t_s
            hit = fm.crash_mask(eng.seed, sats, t_s, exp)
            if hit.any():
                t_crash = fm.crash_times(eng.seed, sats, t_s, exp)
                mask = mask.copy()
                deliveries = list(deliveries)
                for i, d in enumerate(deliveries):
                    if not hit[i]:
                        continue
                    crashed[d.sat] = True
                    mask[d.sat] = False
                    events.append(dict(
                        what="sat_crash", sat=int(d.sat),
                        t_crash=float(t_crash[i]),
                        t_start=float(d.t_start), station=int(d.station),
                        in_flight=bool(d.delivered)))
                    deliveries[i] = dataclasses.replace(
                        d, delivered=False, nbytes=0.0)
    else:
        uplinkers = set(res.merged.keys())
        members = sorted(
            s for ms in res.merged.values() for s in ms
            if s not in uplinkers)
        if members:
            sats = np.asarray(members, dtype=np.int64)
            t_s = np.full(len(members), res.t0)
            exp = np.array([eng.scenario.compute_of(s) for s in members])
            hit = fm.crash_mask(eng.seed, sats, t_s, exp)
            if hit.any():
                t_crash = fm.crash_times(eng.seed, sats, t_s, exp)
                mask = mask.copy()
                for i, s in enumerate(members):
                    if not hit[i]:
                        continue
                    crashed[s] = True
                    mask[s] = False
                    events.append(dict(
                        what="sat_crash", sat=int(s),
                        t_crash=float(t_crash[i]),
                        t_start=float(res.t0), station=None,
                        in_flight=True))
    if not events and res.crashed is None:
        return res
    return dataclasses.replace(
        res, mask=mask, deliveries=deliveries,
        crashed=crashed if crashed.any() else res.crashed,
        faults=(list(res.faults or ()) + events) or None)


def _apply_async_faults(eng: "Engine", records: List[Delivery]
                        ) -> Tuple[List[Delivery], List[dict]]:
    """Shared satellite-crash post-filter for async runs (both engines).

    An upset during a flight destroys the in-flight update (the record
    flips to lost); the sat reboots and keeps training.  The async path
    has no EF revert machinery, so a crash here costs exactly the update
    — the residual-wipe semantics only bind in sync mode.
    """
    fm = eng.faults
    if not records:
        return records, []
    sats = np.array([d.sat for d in records], dtype=np.int64)
    t_s = np.array([d.t_start for d in records])
    exp = np.array([d.t_done for d in records]) - t_s
    ok = np.array([d.delivered for d in records], dtype=bool)
    hit = fm.crash_mask(eng.seed, sats, t_s, exp) & ok
    if not hit.any():
        return records, []
    t_crash = fm.crash_times(eng.seed, sats, t_s, exp)
    events: List[dict] = []
    out = list(records)
    for i, d in enumerate(out):
        if not hit[i]:
            continue
        events.append(dict(what="sat_crash", sat=int(d.sat),
                           t_crash=float(t_crash[i]),
                           t_start=float(d.t_start),
                           station=int(d.station), in_flight=True))
        out[i] = dataclasses.replace(d, delivered=False, nbytes=0.0)
    return out, events


class Engine:
    """Event-queue simulator over a :class:`Scenario`.

    ``policy`` must expose ``assign(t0, msg_bytes, engine)`` returning a
    ``constellation.scheduler.Assignment``; defaults to the contact-plan
    :class:`~repro_torch.constellation.scheduler.Scheduler` configured from the
    scenario.

    ``fast=True`` (the default) routes :meth:`run_round` /
    :meth:`run_async` through the vectorized batch-event core
    (:mod:`repro_torch.sim.fastpath`): structured numpy event arrays with
    same-timestamp batch pops, batched route/window resolution, and a
    cached/vectorized channel stack.  ``fast=False`` keeps the original
    heapq state machine as the reference oracle; the two produce
    bit-identical :class:`Delivery` timelines on any fixed seed (the
    fast path's acceptance contract, enforced by
    ``tests/test_fastpath_equivalence``).
    """

    def __init__(self, scenario: Scenario, policy=None, seed: int = 0,
                 fast: bool = True):
        from .topology import check_plane_compatible, make_topology
        self.scenario = scenario
        self.seed = seed
        self.fast = bool(fast)
        self.topology = make_topology(scenario.topology)
        check_plane_compatible(scenario, self.topology)
        self.channel = scenario.channel   # repro_torch.channel.ChannelModel | None
        self.faults = scenario.faults     # repro_torch.faults.FaultModel | None
        _check_faults_compatible(self.faults, self.topology)
        self.plan = ContactPlan(scenario.walker, scenario.stations,
                                horizon=max(2 * scenario.lookahead, 7200.0),
                                dt=scenario.dt)
        self.router = Router(scenario.walker, scenario.link)
        self._chan_cache = None
        self._fast = None
        self._round_idx = 0       # trace round counter (repro_torch.obs)
        self._async_idx = 0       # trace async-run counter
        self._blocked: Optional[list] = None
        self._refresh_blocked()
        if policy is None:
            from ..constellation.scheduler import Scheduler  # lazy: no cycle
            policy = Scheduler(walker=scenario.walker, gs=scenario.stations,
                               link=scenario.link, k_direct=scenario.k_direct,
                               n_relay=scenario.n_relay,
                               compute_time=scenario.compute_time,
                               lookahead=scenario.lookahead, dt=scenario.dt,
                               max_hops=scenario.max_hops)
        self.policy = policy

    # -- contact-plan / weather / outage plumbing --------------------------
    def _refresh_blocked(self) -> None:
        """Recompute the blocked-window mask aligned with the plan's window
        arrays: weather dropout plus channel conjunction blackouts.

        Blocked-ness is a DETERMINISTIC hash of (seed, station, sat, window
        rise time), not a fresh draw — so extending the plan horizon never
        retroactively flips the availability of a window the simulation
        already consulted.  Conjunction blackouts
        (:class:`repro_torch.channel.outage.ConjunctionBlackout` on the
        scenario's channel) are deterministic functions of the rise time
        and layer into the same mask: a window whose rise falls inside a
        blackout is unusable.  Ground-station blackout faults
        (:class:`repro_torch.faults.FaultModel` ``gs_outage_rate``) layer in the
        same way — a window rising inside a dark slot of its station is
        unusable, which forces re-routing through other stations /
        windows / relays identically in BOTH engines (they consume the
        same mask)."""
        blackout = getattr(self.channel, "blackout", None)
        fm = self.faults
        gs_out = fm is not None and getattr(fm, "gs_enabled", False)
        if self.scenario.dropout <= 0.0 and blackout is None and not gs_out:
            self._blocked = [None] * self.plan.n_stations
            return
        blocked = []
        n = self.scenario.walker.n_sats
        sat_ids = np.arange(n, dtype=np.uint64)[:, None]
        for g, rises in enumerate(self.plan.rises):
            finite = np.isfinite(rises)
            if self.scenario.dropout > 0.0:
                # hand-rolled splitmix64 over the window identity; kept
                # verbatim (not repro_torch.channel.outage.counter_uniforms,
                # which chains its counters differently) so existing
                # seeds keep producing the same weather patterns
                # window identity: its rise index on the immutable time grid
                k = np.where(finite, rises / self.plan.dt, 0.0)
                k = k.astype(np.uint64)
                x = (k * np.uint64(0x9E3779B97F4A7C15)
                     ^ sat_ids * np.uint64(0xBF58476D1CE4E5B9)
                     ^ np.uint64(((g + 1) * 0x94D049BB133111EB) % 2**64)
                     ^ np.uint64((self.seed * 2654435761 + 1) % 2**64))
                # splitmix64 finalizer → uniform in [0, 1)
                x ^= x >> np.uint64(30)
                x *= np.uint64(0xBF58476D1CE4E5B9)
                x ^= x >> np.uint64(27)
                x *= np.uint64(0x94D049BB133111EB)
                x ^= x >> np.uint64(31)
                u = x.astype(np.float64) / float(2**64)
                b = u < self.scenario.dropout
            else:
                b = np.zeros(rises.shape, dtype=bool)
            if blackout is not None:
                phase = (np.where(finite, rises, 0.0)
                         - g * blackout.station_phase) % blackout.period
                b = b | (finite & (phase < blackout.duration))
            if gs_out:
                dark = fm.station_dark(self.seed, g,
                                       np.where(finite, rises, 0.0))
                b = b | (finite & dark)
            blocked.append(b)
        self._blocked = blocked
        trc = _obs_active()
        if trc is not None:
            # outage summary per station: how much of the plan's window
            # budget weather/conjunctions removed.  Re-emitted on every
            # horizon extension (the mask is recomputed), so records carry
            # the horizon to tell refreshes apart; not a DIFF kind.
            for g, b in enumerate(blocked):
                finite = np.isfinite(self.plan.rises[g])
                trc.event("outage", station=g,
                          horizon=float(self.plan.horizon),
                          n_windows=int(finite.sum()),
                          n_blocked=int((b & finite).sum()))

    def ensure(self, t_end: float) -> None:
        old = self.plan.horizon
        # fast path (the per-event call in the async loops): replicate
        # ContactPlan.ensure's early-exit here so the covered case costs
        # one compare and the profiler only times actual extensions
        if t_end <= self.plan.t_start + old:
            return
        trc = _obs_active()
        prof = trc.prof if trc is not None else None
        if prof is not None:
            prof.begin("plan_extend")
        self.plan.ensure(t_end)
        if self.plan.horizon != old:
            self._refresh_blocked()
        if prof is not None:
            prof.end()

    def install_channel(self, channel) -> None:
        """Install (or clear) a lossy channel post-construction.

        Mutating ``engine.channel`` directly is a footgun: the fast
        path's :class:`~repro_torch.sim.fastpath.ChannelCache` may already have
        memoized ARQ plans / estimates for the previous channel, and the
        blocked-window mask may carry its conjunction blackouts.  This is
        the supported install path — it drops the memo wholesale and
        recomputes the mask.  (:class:`repro_torch.core.fedlt_sat.SpaceRunner`
        and :class:`repro_torch.api.Experiment` route through here.)"""
        self.channel = channel
        self._chan_cache = None           # drop memoized plans/estimates
        self._refresh_blocked()           # re-layer conjunction blackouts

    def install_faults(self, faults) -> None:
        """Install (or clear) a fault model post-construction.

        The supported mutation path, mirroring :meth:`install_channel`:
        ground-station blackout faults live in the blocked-window mask,
        so the mask must be recomputed whenever the model changes.
        (:class:`repro_torch.core.fedlt_sat.SpaceRunner` and
        :class:`repro_torch.api.Experiment` route through here.)"""
        _check_faults_compatible(faults, self.topology)
        self.faults = faults
        self._refresh_blocked()           # re-layer GS outage slots

    def usable_window(self, sat: int, t: float
                      ) -> Optional[Tuple[float, float, int]]:
        """Earliest non-blocked window with ``set > t`` across stations."""
        return self.plan.next_window(sat, t, blocked=self._blocked)

    def usable_windows_all(self, t: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized :meth:`usable_window` over all satellites."""
        return self.plan.next_windows_all(t, blocked=self._blocked)

    # -- lossy-channel transmission ----------------------------------------
    def _window_id(self, rise: float) -> int:
        """Stable window identity for channel RNG counters: the rise index
        on the immutable contact-plan time grid."""
        return int(round(rise / self.plan.dt))

    def tx_estimate(self, gateway: int, win, t: float, nbytes: float,
                    gs_tx: float) -> float:
        """Expected GS transmission time for window-fit checks.  The fixed
        ``gs_tx`` without a channel; otherwise the channel's rate/loss-aware
        estimate at the gateway's elevation (channel-aware scheduling)."""
        if self.channel is None:
            return gs_tx
        sc = self.scenario
        return self.channel.estimate_time(
            sc.link, nbytes, walker=sc.walker,
            station_obj=sc.stations[win[2]], gateway=gateway, t=t,
            seed=self.seed, station=win[2],
            window_id=self._window_id(win[0]))

    def tx_commit(self, gateway: int, sat: int, win, t: float,
                  nbytes: float, gs_tx: float) -> Tuple[float, dict]:
        """Execute one GS uplink starting at ``t`` inside ``win``.

        Returns ``(t_done, delivery_kwargs)`` — without a channel this is
        the historical fixed-time transmission; with one it runs the
        windowed selective-repeat ARQ, whose retransmissions consume real
        window time and may truncate the delivery mid-window.
        """
        if self.channel is None:
            return t + gs_tx, dict(nbytes=nbytes, nbytes_attempted=nbytes,
                                   retries=0, delivered=True)
        sc = self.scenario
        res = self.channel.transmit(
            sc.link, nbytes, walker=sc.walker,
            station_obj=sc.stations[win[2]], gateway=gateway, sat=sat,
            t_start=t, window_end=win[1], seed=self.seed, station=win[2],
            window_id=self._window_id(win[0]))
        return res.t_done, dict(nbytes=res.nbytes,
                                nbytes_attempted=res.nbytes_attempted,
                                retries=res.retries, delivered=res.delivered)

    # -- fast-path plumbing ------------------------------------------------
    @property
    def chan_cache(self):
        """Lazily-built :class:`repro_torch.sim.fastpath.ChannelCache`."""
        if self._chan_cache is None:
            from .fastpath import ChannelCache    # lazy: no import cycle
            self._chan_cache = ChannelCache(self)
        return self._chan_cache

    def _fast_state(self):
        """Lazily-built fast-path topology/ISL caches."""
        if self._fast is None:
            from .fastpath import _FastState      # lazy: no import cycle
            self._fast = _FastState(self)
        return self._fast

    # -- synchronous mode --------------------------------------------------
    def run_round(self, t0: float, msg_bytes: float) -> RoundResult:
        """One synchronous round (see the class docstring).  Dispatches
        on the topology first (plane rounds run the in-orbit aggregation
        driver in :mod:`repro_torch.sim.topology`), then to the vectorized fast
        path unless ``fast=False``."""
        trc = _obs_active()
        t_wall = time.perf_counter() if trc is not None else 0.0
        if self.topology.kind != "direct":
            from .topology import run_round_plane
            res = run_round_plane(self, t0, msg_bytes)
        elif self.fast:
            from .fastpath import run_round_fast
            res = run_round_fast(self, t0, msg_bytes)
        else:
            res = self._run_round_oracle(t0, msg_bytes)
        if self.faults is not None and self.faults.crashes_enabled:
            res = _apply_sync_faults(self, res)
        k, self._round_idx = self._round_idx, self._round_idx + 1
        if trc is not None:
            engine = "fast" if self.fast else "oracle"
            trc.prof.begin("trace_emit")
            _emit_round_trace(trc, res, engine, k)
            trc.prof.end()
            trc.prof.flush(trc, engine=engine, mode="sync", round=k,
                           wall=time.perf_counter() - t_wall)
        return res

    def _run_round_oracle(self, t0: float, msg_bytes: float) -> RoundResult:
        sc = self.scenario
        trc = _obs_active()
        prof = trc.prof if trc is not None else None
        self.ensure(t0 + 2 * sc.lookahead)
        if prof is not None:
            prof.begin("assign")
        asg = self.policy.assign(t0, msg_bytes, self)
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
        q: list = []
        seq = itertools.count()

        def push(t, kind, **kw):
            heapq.heappush(q, (t, next(seq), kind, kw))

        tx_state = {g: {"queue": [], "busy": False,
                        "win": asg.windows[g]} for g in asg.gateways}
        station_free: Dict[int, float] = defaultdict(float)
        deliveries: List[Delivery] = []
        hops_of = {s: r.hops for s, r in asg.relays.items()}

        for s in asg.gateways:
            push(t0 + sc.compute_of(s), "train_done", sat=s)
        for s in asg.relays:
            push(t0 + sc.compute_of(s), "train_done", sat=s)

        def try_tx(g, t):
            st = tx_state[g]
            if st["busy"] or not st["queue"]:
                return
            if prof is not None:
                prof.begin("window_fit")
            win = st["win"]
            fit = False
            for _ in range(64):
                if win is None:
                    break
                start = max(t, win[0], station_free[win[2]])
                if start + self.tx_estimate(g, win, start, msg_bytes,
                                            gs_tx) <= win[1]:
                    fit = True
                    break
                win = self.usable_window(g, win[1])
            if prof is not None:
                prof.end()
            if not fit:                         # undeliverable this round
                st["queue"].clear()
                st["win"] = None
                return
            st["win"] = win
            if start > t:
                push(start, "tx_start", gw=g)
                return
            _, sat = st["queue"].pop(0)         # FIFO = arrival order
            st["busy"] = True
            if prof is not None:
                prof.begin("tx_commit")
            t_done, outcome = self.tx_commit(g, sat, win, t, msg_bytes,
                                             gs_tx)
            if prof is not None:
                prof.end()
            station_free[win[2]] = t_done
            push(t_done, "tx_done", gw=g, sat=sat, station=win[2],
                 win_rise=win[0], outcome=outcome)

        if prof is not None:
            prof.begin("event_loop")
        while q:
            t, _, kind, kw = heapq.heappop(q)
            if kind == "train_done":
                s = kw["sat"]
                if s in tx_state:
                    tx_state[s]["queue"].append((t, s))
                    try_tx(s, t)
                else:
                    r = asg.relays[s]
                    push(t + r.time, "isl_arrive", sat=s, gw=r.gateway)
            elif kind == "isl_arrive":
                tx_state[kw["gw"]]["queue"].append((t, kw["sat"]))
                try_tx(kw["gw"], t)
            elif kind == "tx_start":
                try_tx(kw["gw"], t)
            elif kind == "tx_done":
                g, s = kw["gw"], kw["sat"]
                deliveries.append(Delivery(
                    sat=s, t_done=t, t_start=t0, gateway=g,
                    station=kw["station"], hops=hops_of.get(s, 0),
                    window=kw["win_rise"], **kw["outcome"]))
                tx_state[g]["busy"] = False
                try_tx(g, t)
        if prof is not None:
            prof.end()

        mask = np.zeros(n, dtype=bool)
        for d in deliveries:
            if d.delivered:
                mask[d.sat] = True
        duration = (max(d.t_done for d in deliveries) - t0
                    if deliveries else sc.max_compute)
        return RoundResult(mask, float(duration), deliveries, scheduled, t0)

    # -- asynchronous mode -------------------------------------------------
    def run_async(self, t0: float, msg_bytes: float, n_deliveries: int,
                  max_time: Optional[float] = None) -> List[Delivery]:
        """Free-running constellation: each satellite trains, ships its
        update (direct or multi-hop ISL), and retrains on delivery.

        Returns delivery records in time order up to and including the
        ``n_deliveries``-th *successful* one; stops early at ``max_time``
        simulated seconds past ``t0`` (default ``100 × lookahead``) if
        windows run dry.  With a lossy channel the list also contains the
        failed attempts (``delivered=False``) interleaved at their
        completion times — without one every record is a success, so the
        result is exactly the first ``n_deliveries`` deliveries.

        Dispatches to the vectorized fast path unless ``fast=False``.
        """
        if self.topology.kind != "direct":
            raise ValueError(
                f"run_async supports topology='direct' only — plane "
                f"aggregation needs a plane-synchronous merge point, which "
                f"the free-running mode has no analogue of (topology="
                f"{self.topology.name!r})")
        trc = _obs_active()
        t_wall = time.perf_counter() if trc is not None else 0.0
        if self.fast:
            from .fastpath import run_async_fast
            out = run_async_fast(self, t0, msg_bytes, n_deliveries,
                                 max_time=max_time)
        else:
            out = self._run_async_oracle(t0, msg_bytes, n_deliveries,
                                         max_time=max_time)
        fault_events: List[dict] = []
        if self.faults is not None and self.faults.crashes_enabled:
            out, fault_events = _apply_async_faults(self, out)
        run, self._async_idx = self._async_idx, self._async_idx + 1
        if trc is not None:
            engine = "fast" if self.fast else "oracle"
            trc.prof.begin("trace_emit")
            _emit_async_trace(trc, out, engine, run, t0, n_deliveries,
                              fault_events)
            trc.prof.end()
            trc.prof.flush(trc, engine=engine, mode="async", run=run,
                           wall=time.perf_counter() - t_wall)
        return out

    def _run_async_oracle(self, t0: float, msg_bytes: float,
                          n_deliveries: int,
                          max_time: Optional[float] = None) -> List[Delivery]:
        sc = self.scenario
        n = sc.walker.n_sats
        trc = _obs_active()
        prof = trc.prof if trc is not None else None
        gs_tx = sc.link.gs_time(msg_bytes)
        horizon_cap = t0 + (max_time if max_time is not None
                            else 100.0 * sc.lookahead)
        q: list = []
        seq = itertools.count()

        def push(t, kind, **kw):
            heapq.heappush(q, (t, next(seq), kind, kw))

        if prof is not None:
            prof.begin("round_setup")
        tx_state = {s: {"queue": [], "busy": False, "win": None}
                    for s in range(n)}
        station_free: Dict[int, float] = defaultdict(float)
        train_start = {s: t0 for s in range(n)}
        deliveries: List[Delivery] = []

        for s in range(n):
            push(t0 + sc.compute_of(s), "train_done", sat=s)
        if prof is not None:
            prof.end()

        def reachable(sat):
            """(candidate, hops) within max_hops over the ISL graph."""
            seen = {sat: 0}
            frontier = [sat]
            for h in range(1, sc.max_hops + 1):
                nxt = []
                for u in frontier:
                    for v in self.router.neighbors(u):
                        if v not in seen:
                            seen[v] = h
                            nxt.append(v)
                frontier = nxt
            return seen.items()

        def choose_route(sat, t):
            """Best (gateway, isl_time, hops) by estimated delivery time."""
            best, best_est = None, np.inf
            for cand, hops in reachable(sat):
                isl_t = self.router.link.isl_time(msg_bytes, hops=hops) if hops else 0.0
                w = self.usable_window(cand, t + isl_t)
                if w is None:
                    continue
                st = tx_state[cand]
                backlog = (len(st["queue"]) + (1 if st["busy"] else 0)) * gs_tx
                est = max(t + isl_t, w[0]) + backlog + gs_tx
                if est < best_est or (est == best_est and best is not None
                                      and hops < best[2]):
                    best, best_est = (cand, isl_t, hops), est
            return best

        def park(st, t):
            """No usable window for this gateway: re-route the backlog.

            Retries only schedule strictly before the horizon cap — a
            retry AT the cap can land back here (dispatch → self-route →
            window never fits → park) and would re-push at the same
            saturated time forever instead of letting the run drain.
            """
            if t < horizon_cap:
                for _, parked, _h in st["queue"]:
                    push(min(t + sc.lookahead, horizon_cap), "retry",
                         sat=parked)
            st["queue"].clear()
            st["win"] = None

        def try_tx(g, t):
            st = tx_state[g]
            if st["busy"] or not st["queue"]:
                return
            if prof is not None:
                prof.begin("window_fit")
            win = st["win"]
            if win is None or win[1] <= t:
                win = self.usable_window(g, t)
            fit = False
            for _ in range(64):
                if win is None:
                    break
                start = max(t, win[0], station_free[win[2]])
                if start + self.tx_estimate(g, win, start, msg_bytes,
                                            gs_tx) <= win[1]:
                    fit = True
                    break
                win = self.usable_window(g, win[1])
            if prof is not None:
                prof.end()
            if not fit:
                park(st, t)
                return
            st["win"] = win
            if start > t:
                push(start, "tx_start", gw=g)
                return
            meta = st["queue"].pop(0)
            st["busy"] = True
            if prof is not None:
                prof.begin("tx_commit")
            t_done, outcome = self.tx_commit(g, meta[1], win, t, msg_bytes,
                                             gs_tx)
            if prof is not None:
                prof.end()
            station_free[win[2]] = t_done
            push(t_done, "tx_done", gw=g, sat=meta[1], hops=meta[2],
                 station=win[2], win_rise=win[0], outcome=outcome)

        def dispatch(s, t):
            if prof is not None:
                prof.begin("route")
            route = choose_route(s, t)
            if prof is not None:
                prof.end()
            if route is None:
                if t < horizon_cap:
                    push(min(t + sc.lookahead, horizon_cap), "retry", sat=s)
                return
            gw, isl_t, hops = route
            if gw == s:
                tx_state[s]["queue"].append((t, s, 0))
                try_tx(s, t)
            else:
                push(t + isl_t, "isl_arrive", sat=s, gw=gw, hops=hops)

        n_ok = 0
        if prof is not None:
            prof.begin("event_loop")
        while q and n_ok < n_deliveries:
            t, _, kind, kw = heapq.heappop(q)
            if t > horizon_cap:
                break
            self.ensure(t + 2 * sc.lookahead)
            if kind == "train_done":
                dispatch(kw["sat"], t)
            elif kind == "retry":
                dispatch(kw["sat"], t)
            elif kind == "isl_arrive":
                tx_state[kw["gw"]]["queue"].append((t, kw["sat"], kw["hops"]))
                try_tx(kw["gw"], t)
            elif kind == "tx_start":
                try_tx(kw["gw"], t)
            elif kind == "tx_done":
                g, s = kw["gw"], kw["sat"]
                deliveries.append(Delivery(
                    sat=s, t_done=t, t_start=train_start[s], gateway=g,
                    station=kw["station"], hops=kw["hops"],
                    window=kw["win_rise"], **kw["outcome"]))
                if kw["outcome"]["delivered"]:
                    n_ok += 1
                tx_state[g]["busy"] = False
                try_tx(g, t)
                # the satellite retrains either way: on success it picks up
                # the fresh global model; on a lost uplink it moves on (its
                # stale update is gone — sync mode's loss-robust EF has no
                # async analogue yet)
                train_start[s] = t
                push(t + sc.compute_of(s), "train_done", sat=s)
        if prof is not None:
            prof.end()

        # records are appended in heap-pop order, i.e. sorted by t_done;
        # the loop stops right after the n_deliveries-th success, so the
        # lossless case returns exactly n_deliveries records
        return deliveries
