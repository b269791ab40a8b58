"""Fed-LTSat (paper Algorithm 3): the federated runner over the simulator.

Algorithm 3 is Algorithm 2 (Fed-LT with compression and EF) with the
active set S_k chosen by the orbit-aware scheduler, and uplinks either
direct to a ground station or forwarded over multi-hop ISLs.  The updates
are the same; the time and bandwidth accounting differ, which is what the
paper's Table 2 measures.

Counterpart of ``repro.core.fedlt_sat``.  The runner drives any algorithm
with ``init``/``round`` through the port's discrete-event engine
(:mod:`repro_torch.sim.engine`) in one of two aggregation modes:

  * ``mode="sync"``: one engine round per communication round.  The
    policy schedules gateways and ISL relays, the engine executes the
    plan, and the coordinator aggregates when the last scheduled update
    lands.
  * ``mode="async"``: FedBuff-style buffered asynchrony.  Satellites train
    and deliver continuously; every ``buffer_size`` landed updates the
    coordinator aggregates once, weighting each satellite's received wire
    by ``(1 + staleness)^(-staleness_alpha)``, where staleness counts the
    aggregations that happened while the update was in flight.

The engine is numpy host code; the algorithm's state lives on a torch
device (the card unless the caller built it on the CPU).  Per-round masks
go to the state's device with ``torch.as_tensor``, and the algorithm's
random numbers come from one ``torch.Generator`` on that device,
re-seeded before round k with :func:`round_seeds`'s k-th seed (the
counterpart of the JAX package's ``jax.random.split(key, n_rounds)``), so
a run resumed from a checkpoint replays the rounds it missed with the
same draws.  ``alg.round`` runs eagerly (no ``jit``).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..constellation.links import message_bytes
from ..faults import quorum_close_time
from ..obs.trace import active as _obs_active
from .compression import Compressor
from .error_feedback import resync_cache
from .pytree import tree_leaves, tree_map, tree_size, tree_split_keys, tree_where_mask


@dataclasses.dataclass
class RoundLog:
    round: int
    time: float            # simulated seconds since start
    bytes_up: float        # cumulative uplink bytes over GS links (air
    #                        bytes: with a lossy channel this counts
    #                        retransmissions and truncated attempts too)
    n_active: int          # updates the coordinator actually received
    error: Optional[float] = None
    staleness: Optional[float] = None   # async: mean staleness this round
    n_lost: int = 0        # attempted uplinks the channel destroyed
    bytes_isl: float = 0.0  # cumulative ISL bytes (in-orbit aggregation)


def _device_of(state) -> torch.device:
    return tree_leaves(state.x)[0].device


def round_seeds(seed: int, n_rounds: int) -> List[int]:
    """One generator seed per round, drawn from a CPU generator seeded with
    ``seed``.  Round k's seed depends on ``seed`` and k only, not on
    ``n_rounds``: a longer run, or one resumed at round k, draws round k's
    numbers as the first run did."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2**62, (n_rounds,), generator=g).tolist()


@dataclasses.dataclass(frozen=True, eq=False)
class SpaceRunner:
    """Drives a federated algorithm through the constellation simulator.

    ``engine`` is a :class:`repro_torch.sim.engine.Engine`; a bare
    :class:`~repro_torch.constellation.scheduler.Scheduler` is also
    accepted and wrapped in an engine over its own single-station
    scenario.

    With a lossy channel (``channel=`` here or on the engine's scenario),
    sync rounds tell *attempted* from *delivered* uplinks: lost satellites
    still train and pay air time, the coordinator's received wire reverts,
    and with ``loss_robust=True`` and an EF-caching algorithm the uplink
    residual reverts too, so the cached content telescopes into the next
    successful transmission (:func:`_revert_lost_wires`).
    """

    engine: object
    wire_bits: float = 32.0      # nominal fallback (no-codec compressors)
    mode: str = "sync"           # "sync" | "async"
    buffer_size: int = 8         # async: aggregate every M landed updates
    staleness_alpha: float = 0.5  # async: wire weight (1+s)^(-alpha)
    compressor: Optional[Compressor] = None  # → measured WireMessage bytes
    # lossy channel (repro_torch.channel.ChannelModel): installed on the
    # engine; an engine whose Scenario already carries one needs none here
    channel: Optional[object] = None
    # loss-robust EF (sync mode): a destroyed uplink's EF residual reverts
    # instead of being discharged into the lost wire.  Needs an algorithm
    # with an uplink cache (``c_up``).
    loss_robust: bool = True
    # byte measurement:
    #   "probe"  — encode ONE representative message up front; every
    #              delivery is accounted at that size
    #   "cohort" — account each sync round from the actually-transmitted
    #              wire state, grouped per contact-window cohort
    measure: str = "probe"       # "probe" | "cohort" (sync mode only)
    # node-level fault injection (repro_torch.faults.FaultModel): crashed
    # satellites lose their in-flight update AND their EF residual
    faults: Optional[object] = None
    # round deadline with quorum (sync mode): the round closes at
    # t0 + deadline provided ≥ quorum·attempted update-weights landed (else
    # at the quorum-completing landing); later deliveries are stragglers,
    # treated as erasures.  None = wait for the last scheduled delivery.
    deadline: Optional[float] = None
    quorum: float = 0.0

    def __post_init__(self):
        if hasattr(self.engine, "select") and not hasattr(self.engine, "run_round"):
            object.__setattr__(self, "engine", self.engine._engine())
        if self.channel is not None:
            # the engine's install path also invalidates its ChannelCache
            # memo, which may hold ARQ plans for the previous channel
            if hasattr(self.engine, "install_channel"):
                self.engine.install_channel(self.channel)
            else:                            # wrapped non-Engine stand-ins
                self.engine.channel = self.channel
                self.engine._refresh_blocked()
        if self.faults is not None:
            if hasattr(self.engine, "install_faults"):
                self.engine.install_faults(self.faults)
            else:                            # wrapped non-Engine stand-ins
                self.engine.faults = self.faults
                self.engine._refresh_blocked()
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {self.mode!r}")
        if self.deadline is not None:
            if self.mode != "sync":
                raise ValueError(
                    "deadline/quorum round closing is sync-only — async "
                    "FedBuff aggregation has no round boundary to close")
            if self.deadline <= 0.0:
                raise ValueError(f"deadline must be > 0: {self.deadline}")
        if not 0.0 <= self.quorum <= 1.0:
            raise ValueError(f"quorum must be in [0,1]: {self.quorum}")
        if self.measure not in ("probe", "cohort"):
            raise ValueError(
                f"measure must be 'probe' or 'cohort', got {self.measure!r}")
        if self.measure == "cohort" and self.mode == "async":
            raise ValueError(
                "measure='cohort' needs per-round RoundResults and is sync-"
                "only; async runs account deliveries at the probe size")
        topo = getattr(self.engine, "topology", None)
        if topo is not None and getattr(topo, "kind", "direct") != "direct":
            if self.mode == "async":
                raise ValueError(
                    "mode='async' needs topology='direct' — plane "
                    "aggregation has no free-running merge point")
            if self.measure == "cohort":
                raise ValueError(
                    "measure='cohort' groups per-satellite wires by "
                    "contact window; plane topologies uplink one merged "
                    "wire per head — use measure='probe'")

    # -- shared setup ------------------------------------------------------
    def _msg_bytes(self, state) -> float:
        """On-wire size of one per-agent update.

        With a ``compressor`` whose wire codec exists, one representative
        per-agent message is encoded (:mod:`repro_torch.wire`) and its exact
        ``WireMessage.nbytes`` drives every engine transmission time and
        ``bytes_up`` log.  The nominal ``wire_bits`` estimate is the
        fallback for compressors without a codec.
        """
        if self.compressor is not None and \
                self.compressor.wire_codec() is not None:
            from ..wire.codecs import measure_tree_bytes  # lazy: wire imports core
            # a random probe with the per-agent shapes, run through the
            # compressor (zeros would make sparse codecs count an empty
            # payload); drawn from explicit generators, seeds 0 and 1
            template = tree_map(lambda x: x[0], state.x)
            dev = _device_of(state)
            gens = tree_split_keys(torch.Generator(device=dev).manual_seed(0),
                                   template)
            probe = tree_map(lambda g, t: torch.randn(
                t.shape, generator=g, dtype=t.dtype, device=dev), gens, template)
            wire = self.compressor(torch.Generator(device=dev).manual_seed(1),
                                   probe)
            return measure_tree_bytes(self.compressor, wire)
        n_params = tree_size(state.x) // tree_leaves(state.x)[0].shape[0]
        return message_bytes(n_params, self.wire_bits)

    def run(self, alg, state, data, n_rounds: int, seed: int = 0,
            error_fn: Optional[Callable] = None,
            log_every: int = 10, ckpt=None, ckpt_every: int = 1,
            resume: bool = False) -> tuple:
        """Drive ``n_rounds`` rounds; returns ``(state, [RoundLog, ...])``.

        Before round k the ``torch.Generator`` (on the state's device) that
        the algorithm's stochastic compressors draw from is seeded with
        ``round_seeds(seed, n_rounds)[k]``.  ``ckpt`` (a
        :class:`repro_torch.checkpoint.run.RunCheckpoint`) checkpoints the
        run every ``ckpt_every`` sync rounds; ``resume=True`` restarts from
        the newest intact checkpoint and continues bit for bit as the
        uninterrupted run (sync mode only: the async delivery stream has
        no round boundary to checkpoint at)."""
        seeds = round_seeds(seed, n_rounds)
        if self.mode == "async":
            if ckpt is not None or resume:
                raise ValueError("checkpoint/resume is sync-only")
            return self._run_async(alg, state, data, n_rounds, seeds,
                                   error_fn, log_every)
        return self._run_sync(alg, state, data, n_rounds, seeds, error_fn,
                              log_every, ckpt=ckpt, ckpt_every=ckpt_every,
                              resume=resume)

    def _cohort_nbytes(self, state, cohorts) -> dict:
        """Measured on-wire bytes per satellite, grouped per cohort.

        Quant codecs have shape-static sizes, so each update is costed
        analytically (``tree_nbytes`` of one satellite's slice, no encode;
        the transmit-side compute of a cohort is the fused kernel that
        :mod:`repro_torch.bench.sim_scale` times, not re-run here).  Other
        codecs encode each update from the actually-transmitted wire
        state, so content-dependent payload sizes are exact.
        """
        from ..wire.codecs import QuantCodec  # lazy: wire imports core
        codec = self.compressor.wire_codec()
        wire_field = "z_hat" if hasattr(state, "z_hat") else "m_hat"
        tree = getattr(state, wire_field)
        template = tree_map(lambda x: x[0], tree)
        static_nb = (float(codec.tree_nbytes(template))
                     if isinstance(codec, QuantCodec) else None)
        out: dict = {}
        for cohort in cohorts:
            if static_nb is not None:
                for s in cohort.sats:
                    out[s] = static_nb
                continue
            for s in cohort.sats:
                one = tree_map(lambda x: x[s], tree)
                out[s] = float(codec.encode(one).nbytes)
        return out

    # -- synchronous rounds ------------------------------------------------
    def _run_sync(self, alg, state, data, n_rounds, seeds, error_fn,
                  log_every, ckpt=None, ckpt_every: int = 1,
                  resume: bool = False):
        msg = self._msg_bytes(state)
        use_cohorts = (self.measure == "cohort" and self.compressor is not None
                       and self.compressor.wire_codec() is not None)
        channel = getattr(self.engine, "channel", None)
        wire_field = "z_hat" if hasattr(state, "z_hat") else "m_hat"
        has_cache = hasattr(state, "c_up")
        dev = _device_of(state)
        gen = torch.Generator(device=dev)
        t, up_bytes, isl_bytes = 0.0, 0.0, 0.0
        logs: List[RoundLog] = []
        trc = _obs_active()       # read once; None ⇒ tracing fully off
        start_k = 0
        if ckpt is not None and resume:
            loaded = ckpt.load(like=state)
            if loaded is not None:
                # bit-identical continuation: round k's seed is seeds[k],
                # engine rounds are pure functions of (scenario, seed, t0),
                # and the time cursor and accumulators restore exactly, so
                # rounds >= start_k replay the uninterrupted run's floats
                state, meta = loaded
                start_k = int(meta.get("k_next", 0))
                t = float(meta.get("t", 0.0))
                up_bytes = float(meta.get("up_bytes", 0.0))
                isl_bytes = float(meta.get("isl_bytes", 0.0))
                logs = [RoundLog(**d) for d in meta.get("logs", [])]
                if hasattr(self.engine, "_round_idx"):
                    self.engine._round_idx = start_k   # trace round labels
                if trc is not None:
                    # replay the prefix's curves so a resumed trace carries
                    # the full series
                    trc.event("resume", k_next=start_k, t=float(t),
                              bytes_up=float(up_bytes))
                    for lg in logs:
                        trc.series("bytes_up", lg.round, lg.bytes_up)
                        if lg.error is not None:
                            trc.series("e_K", lg.round, lg.error)
        for k in range(start_k, n_rounds):
            if trc is None:
                res = self.engine.run_round(t, msg)
            else:
                with trc.span("stage", name="engine.run_round", round=k):
                    res = self.engine.run_round(t, msg)
            t_round0 = t
            delivered = res.mask
            attempted = np.zeros_like(delivered)
            merged = getattr(res, "merged", None)
            if merged is not None:
                # in-orbit aggregation: one head delivery stands for every
                # member it merged, so a lost head wire loses (and, below,
                # reverts) the whole plane
                for d in res.deliveries:
                    attempted[list(merged[d.sat])] = True
            else:
                for d in res.deliveries:
                    attempted[d.sat] = True
            aborted = getattr(res, "aborted", None)
            if aborted is not None:
                # updates destroyed in orbit with no delivery record
                # (head-failover collateral): attempted-but-lost
                attempted = attempted | aborted
            crashed = getattr(res, "crashed", None)
            duration = res.duration
            if self.deadline is not None:
                # quorum round closing: anything landing after t_close is a
                # straggler whose wire (and, with loss_robust, residual)
                # reverts below; its content folds into the next round via EF
                landed = [(d.t_done,
                           len(merged[d.sat]) if merged is not None else 1)
                          for d in res.deliveries if d.delivered]
                t_close = quorum_close_time(
                    t_round0, self.deadline, self.quorum, landed,
                    int(attempted.sum()))
                late = np.zeros_like(delivered)
                for d in res.deliveries:
                    if d.delivered and d.t_done > t_close:
                        if merged is not None:
                            late[list(merged[d.sat])] = True
                        else:
                            late[d.sat] = True
                delivered = delivered & ~late
                duration = max(t_close - t_round0, 0.0)
            lost = attempted & ~delivered
            lossy = bool(lost.any())
            # satellites that transmitted but were lost still trained and
            # paid the uplink: they take part in the round, then the
            # coordinator-side wire is reverted below
            active_np = attempted if lossy else delivered
            active = torch.as_tensor(active_np, dtype=torch.bool, device=dev)
            gen.manual_seed(seeds[k])
            if trc is None:
                state_new, _ = alg.round(state, data, active, gen)
            else:
                with trc.span("stage", name="alg.round", round=k,
                              n_active=int(active_np.sum())):
                    state_new, _ = alg.round(state, data, active, gen)
            # what each satellite put on the air this round: for lost
            # satellites that is the PRE-revert wire, so cohort byte
            # accounting below measures this state, not the final one
            tx_state = state_new
            if lossy:
                absorb = self.loss_robust and has_cache
                state_new = _revert_lost_wires(
                    state_new, state, wire_field,
                    torch.as_tensor(lost, dtype=torch.bool, device=dev),
                    absorb=absorb)
                if trc is not None:
                    # resid_norm: ‖c_up[lost]‖ after the revert
                    lost_idx = np.nonzero(lost)[0]
                    norm2 = 0.0
                    if has_cache:
                        sel = torch.as_tensor(lost_idx, device=dev)
                        for leaf in tree_leaves(state_new.c_up):
                            arr = leaf[sel].to(torch.float64)
                            norm2 += float((arr * arr).sum())
                    trc.event("ef_revert", round=k, n_lost=int(lost.sum()),
                              sats=[int(s) for s in lost_idx],
                              absorb=bool(absorb),
                              resid_norm=float(np.sqrt(norm2)))
                    trc.metrics.counter("ef_reverts").add(float(lost.sum()))
                    trc.series("ef_resid_norm", k, float(np.sqrt(norm2)))
            if crashed is not None and bool(crashed.any()) and has_cache:
                # crash semantics: the rebooted satellite's memory is gone,
                # so c_up re-syncs to zero for crashed rows
                state_new = state_new._replace(
                    c_up=resync_cache(state_new.c_up, crashed))
                if trc is not None:
                    trc.event("ef_resync", round=k,
                              n_crashed=int(crashed.sum()),
                              sats=[int(s) for s in np.nonzero(crashed)[0]])
                    trc.metrics.counter("ef_resyncs").add(
                        float(crashed.sum()))
            state = state_new
            t += duration
            # bytes_up = air bytes that crossed the GS links this round
            if use_cohorts:
                per_sat = self._cohort_nbytes(tx_state, res.cohorts())
                if channel is not None:
                    up_bytes += sum(
                        per_sat[d.sat] * (d.nbytes_attempted / msg)
                        for d in res.deliveries)
                else:
                    up_bytes += sum(per_sat.values())
            else:
                up_bytes += sum(d.nbytes_attempted for d in res.deliveries)
            isl_bytes += float(getattr(res, "bytes_isl", 0.0))
            err = (float(error_fn(state))
                   if error_fn is not None and (k % log_every == 0
                                                or k == n_rounds - 1) else None)
            logs.append(RoundLog(k, t, up_bytes, int(delivered.sum()), err,
                                 n_lost=int(lost.sum()),
                                 bytes_isl=isl_bytes))
            if trc is not None:
                # downlink ledger: the coordinator rebroadcasts the model to
                # every satellite it scheduled
                down = trc.metrics.counter("bytes_down")
                down.add(msg * float(res.scheduled.sum()))
                plane_kw = ({} if merged is None
                            else dict(bytes_isl=float(isl_bytes)))
                trc.event("fl_round", round=k, t0=float(t_round0),
                          t=float(t), bytes_up=float(up_bytes),
                          n_active=int(delivered.sum()),
                          n_lost=int(lost.sum()),
                          error=err if err == err else None,
                          mode="sync", **plane_kw)
                trc.series("bytes_up", k, up_bytes)
                trc.series("bytes_down", k, down.total)
                if merged is not None:
                    trc.series("bytes_isl_cum", k, isl_bytes)
                n_att = int(attempted.sum())
                trc.series("lost_frac", k,
                           float(lost.sum()) / n_att if n_att else 0.0)
                n_surv = int(delivered.sum())
                trc.series("survivors", k, float(n_surv))
                trc.series("quorum_frac", k,
                           n_surv / n_att if n_att else 1.0)
                if err is not None and err == err:
                    trc.series("e_K", k, err)
            if ckpt is not None and ((k + 1) % ckpt_every == 0
                                     or k == n_rounds - 1):
                ckpt.save_round(state, step=k + 1, t=t, up_bytes=up_bytes,
                                isl_bytes=isl_bytes, logs=logs)
        return state, logs

    # -- buffered-async (FedBuff-style) -------------------------------------
    def _run_async(self, alg, state, data, n_rounds, seeds, error_fn,
                   log_every):
        msg = self._msg_bytes(state)
        n_agents = tree_leaves(state.x)[0].shape[0]
        wire_field = "z_hat" if hasattr(state, "z_hat") else "m_hat"
        dev = _device_of(state)
        gen = torch.Generator(device=dev)

        trc = _obs_active()       # read once; None ⇒ tracing fully off
        if trc is None:
            records = self.engine.run_async(
                0.0, msg, n_deliveries=n_rounds * self.buffer_size)
        else:
            with trc.span("stage", name="engine.run_async",
                          n_deliveries=n_rounds * self.buffer_size):
                records = self.engine.run_async(
                    0.0, msg, n_deliveries=n_rounds * self.buffer_size)
        # only landed updates feed the aggregator; failed attempts' air
        # bytes still count toward the uplink ledger below
        deliveries = [d for d in records if d.delivered]
        rec_ptr = 0
        agg_times: List[float] = []
        logs: List[RoundLog] = []
        up_bytes = 0.0
        for k in range(n_rounds):
            chunk = deliveries[k * self.buffer_size:(k + 1) * self.buffer_size]
            if not chunk:
                break           # windows ran dry before n_rounds aggregations
            active_np = np.zeros(n_agents, dtype=bool)
            stale = np.zeros(n_agents, dtype=np.float64)
            for d in chunk:
                active_np[d.sat] = True
                stale[d.sat] = len(agg_times) - bisect.bisect_right(
                    agg_times, d.t_start)
            weights = np.where(active_np,
                               (1.0 + stale) ** (-self.staleness_alpha), 1.0)
            active = torch.as_tensor(active_np, dtype=torch.bool, device=dev)
            gen.manual_seed(seeds[k])
            if trc is None:
                new_state, _ = alg.round(state, data, active, gen)
            else:
                with trc.span("stage", name="alg.round", round=k,
                              n_active=int(active_np.sum())):
                    new_state, _ = alg.round(state, data, active, gen)
            state = _damp_wires(new_state, state, wire_field,
                                torch.as_tensor(weights, dtype=torch.float32,
                                                device=dev))
            t0_agg = chunk[0].t_start
            t = chunk[-1].t_done
            agg_times.append(t)
            n_lost_win = 0
            while rec_ptr < len(records) and records[rec_ptr].t_done <= t:
                up_bytes += records[rec_ptr].nbytes_attempted
                n_lost_win += not records[rec_ptr].delivered
                rec_ptr += 1
            err = (float(error_fn(state))
                   if error_fn is not None and (k % log_every == 0
                                                or k == n_rounds - 1) else None)
            mean_stale = float(stale[active_np].mean())
            logs.append(RoundLog(k, t, up_bytes, int(active_np.sum()), err,
                                 staleness=mean_stale))
            if trc is not None:
                hist = trc.metrics.histogram("staleness", lo=0.0)
                for d in chunk:
                    hist.observe(float(stale[d.sat]))
                down = trc.metrics.counter("bytes_down")
                down.add(msg * float(active_np.sum()))
                trc.event("fl_round", round=k, t0=float(t0_agg),
                          t=float(t), bytes_up=float(up_bytes),
                          n_active=int(active_np.sum()),
                          n_lost=n_lost_win, staleness=mean_stale,
                          error=err if err == err else None,
                          mode="async")
                trc.series("bytes_up", k, up_bytes)
                trc.series("bytes_down", k, down.total)
                trc.series("staleness", k, mean_stale)
                n_win = len(chunk) + n_lost_win
                trc.series("lost_frac", k,
                           n_lost_win / n_win if n_win else 0.0)
                if err is not None and err == err:
                    trc.series("e_K", k, err)
        return state, logs


def _revert_lost_wires(new_state, old_state, field: str, lost,
                       *, absorb: bool):
    """Coordinator-side fix-up for channel-destroyed uplinks.

    The round ran with the lost satellites active (they trained and
    transmitted), but the coordinator never received their wire: its
    received-wire slot (``z_hat``/``m_hat``) reverts to the previous value.

    With ``absorb=True`` (loss-robust EF) the satellite's uplink residual
    reverts too: ``c_up ← c_up_old``.  The EF update
    ``c ← (msg + c_old) − wire`` discharges the cached residual into the
    wire, which is right only if the wire lands.  Reverting on loss keeps
    it in the cache, so the lost round's content telescopes into the
    agent's next successful transmission (paper §2.2).  Without the revert
    (naive lossy EF) the residual vanishes from the bookkeeping.
    ``lost`` is an ``(N,)`` bool tensor on the state's device.
    """
    wire_new = getattr(new_state, field)
    wire_old = getattr(old_state, field)
    out = new_state._replace(
        **{field: tree_where_mask(lost, wire_old, wire_new)})
    if absorb:
        out = out._replace(c_up=tree_where_mask(lost, old_state.c_up,
                                                new_state.c_up))
    return out


def _damp_wires(new_state, old_state, field: str, weights):
    """Staleness-weighted server step: blend the coordinator's received
    wires between this round's value and the previous one, per agent.
    Agents whose wire did not change this round are unaffected.
    ``weights`` is an ``(N,)`` float32 tensor on the state's device."""
    new_wire = getattr(new_state, field)
    old_wire = getattr(old_state, field)

    def blend(nw, ow):
        w = weights.reshape((-1,) + (1,) * (nw.ndim - 1))
        return w * nw + (1.0 - w) * ow

    return new_state._replace(**{field: tree_map(blend, new_wire, old_wire)})
