"""Bytes-to-ground vs e_K frontier for in-orbit aggregation (topology table).

Counterpart of the JAX package's ``benchmarks/table_plane_agg.py``.  Two
sweeps over :class:`repro_torch.api.Experiment`, every arm traced and
folded into a run ledger (``results/torch/ledger_plane_agg.jsonl``), the
printed table rebuilt only from the ledger entries
(:func:`repro_torch.obs.report.plane_agg_rows`):

  * **walker frontier**: the 100-sat geometry under ``direct`` (per-sat
    uplinks, scheduler-limited participation), ``plane`` (per-plane
    convergecast to elected heads) and ``gossip`` (paired head merge);
  * **mega comparison**: the 1000-sat / 20-plane regime: ``direct`` (the
    standard ``mega-1000`` schedule), ``direct-full`` (relay fan-out
    boosted until every satellite ships its own wire, the
    equal-participation baseline) and ``plane`` (20 head wires carry all
    1000 updates).

Headline metric: plane aggregation cuts GS bytes per incorporated update
by ≥ 5× against the equal-participation direct baseline, with e_K within
1.25× at equal rounds.  Each printed row also gives the arm's wall time
per round.

``--smoke`` runs no training: it drives the ``plane-agg-walker`` engine
rounds on the fast path and the heapq oracle under obs traces and exits 1
unless the port's trace diff is clean.  Runs on the card:

    PYTHONPATH=src python -m repro_torch.bench.table_plane_agg [--quick|--smoke]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from ..api import Experiment
from ..core.compression import UniformQuantizer
from ..core.error_feedback import EFChannel
from ..core.fedlt import FedLT, optimality_error
from ..obs.ledger import load_ledger
from ..obs.report import plane_agg_rows
from ..sim import Engine, get_scenario
from .common import RESULTS_DIR, TUNED, logistic_problem

LEDGER = os.path.join(RESULTS_DIR, "ledger_plane_agg.jsonl")

# (arm label, scenario factory): scenario name or a Scenario instance
WALKER_ARMS = [
    ("direct", "walker-kiruna"),
    ("plane", "plane-agg-walker"),
    ("gossip", "plane-agg-gossip"),
]


def _mega_full():
    # equal-participation direct baseline: boost the relay fan-out until
    # the schedule covers the whole fleet (40 gateways × (1 + 24 relays)
    # = 1000), so the per-update byte comparison is participation-matched
    return dataclasses.replace(get_scenario("mega-1000"),
                               name="mega-1000-full",
                               k_direct=40, n_relay=24)


def MEGA_ARMS():
    return [
        ("direct", get_scenario("mega-1000")),
        ("direct-full", _mega_full()),
        ("plane", get_scenario("mega-1000-plane")),
    ]


def render_row(row: dict) -> str:
    per_upd = (row["bytes_gs"] / row["updates"] if row["updates"]
               else float("inf"))
    return (f"{row['scenario']:18s} {row['arm']:12s} "
            f"[{row['topology']:6s}] e_K={row['error']:.5f}  "
            f"gs={row['bytes_gs'] / 1e3:8.1f}kB  "
            f"isl={row['bytes_isl'] / 1e3:8.1f}kB  "
            f"upd={row['updates']:6d}  gs/upd={per_upd / 1e3:6.2f}kB")


def run_sweep(arms, *, rounds, n_agents, dim, m, seed=0, group="",
              ledger_path=LEDGER, device=None, ms=None):
    """One (arm × scenario) sweep on a shared problem; returns the sweep's
    ledger entries in arm order.  Each arm's wall ms per round is appended
    to ``ms`` when given."""
    data, loss, x_star = logistic_problem(seed, n_agents=n_agents, m=m,
                                          dim=dim, device=device)
    C = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    err = lambda s: float(optimality_error(s.x, x_star))  # noqa: E731
    run_ids = []
    for arm, scenario in arms:
        alg = FedLT(loss=loss, uplink=EFChannel(C), downlink=EFChannel(C),
                    **TUNED)
        exp = Experiment(scenario, alg, compressor=C, seed=seed,
                         device=device,
                         meta=dict(arm=arm, group=group, rounds=rounds,
                                   seed=seed))
        st = exp.init(torch.zeros(dim), n_agents)
        t0 = time.perf_counter()
        res = exp.run(st, data, rounds, 100 + seed, error_fn=err,
                      log_every=max(1, rounds // 5), ledger=ledger_path)
        if ms is not None:
            ms.append(1e3 * (time.perf_counter() - t0) / rounds)
        run_ids.append(res.run_id)
    by_id = {e["run_id"]: e for e in load_ledger(ledger_path)}
    return [by_id[r] for r in run_ids]


def run(quick=False, ledger_path=LEDGER, device=None):
    w_rounds = 20 if quick else 60
    m_rounds = 4 if quick else 8
    ms = []
    entries = run_sweep(WALKER_ARMS, rounds=w_rounds, n_agents=100,
                        dim=32, m=40, group="walker",
                        ledger_path=ledger_path, device=device, ms=ms)
    entries += run_sweep(MEGA_ARMS(), rounds=m_rounds, n_agents=1000,
                         dim=8, m=16, group="mega",
                         ledger_path=ledger_path, device=device, ms=ms)
    rows = plane_agg_rows(entries)
    for row, t in zip(rows, ms):
        print(f"{render_row(row)}  {t:.3f} ms/round")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, "table_plane_agg.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def main(quick=False, device=None):
    t0 = time.time()
    rows = run(quick=quick, device=device)
    by = {(r["scenario"], r["arm"]): r for r in rows}
    full = by[("mega-1000-full", "direct-full")]
    plane = by[("mega-1000-plane", "plane")]
    per_upd_full = full["bytes_gs"] / max(full["updates"], 1)
    per_upd_plane = plane["bytes_gs"] / max(plane["updates"], 1)
    reduction = per_upd_full / per_upd_plane
    ek_ratio = plane["error"] / full["error"]
    us = (time.time() - t0) * 1e6
    print(f"table_plane_agg,{us:.0f},gs_bytes_per_update_reduction="
          f"{reduction:.1f},ek_ratio_plane_over_direct={ek_ratio:.3f}")
    ok = reduction >= 5.0 and ek_ratio <= 1.25
    print(f"acceptance: reduction>=5x {'PASS' if reduction >= 5.0 else 'FAIL'}"
          f", ek_ratio<=1.25 {'PASS' if ek_ratio <= 1.25 else 'FAIL'}")
    return ok


def smoke(rounds=4) -> bool:
    """Topology-equivalence gate: fast vs heapq-oracle engine rounds on
    ``plane-agg-walker`` must trace-diff clean (round / delivery /
    head_elect event streams identical).  No training, seconds to run."""
    from ..obs import tracing
    from ..obs.summary import check, diff

    msg = 120e6 / 8 * 0.01
    traces = []
    for fast in (True, False):
        eng = Engine(get_scenario("plane-agg-walker"), fast=fast)
        with tracing() as trc:
            t = 0.0
            for _ in range(rounds):
                res = eng.run_round(t, msg)
                t += res.duration
            traces.append(trc.records())
    equal, report = diff(traces[0], traces[1])
    bad = check(traces[0]) + check(traces[1])
    if equal and not bad:
        n = len([r for r in traces[0] if r.get("kind") == "delivery"])
        print(f"topology-equivalence OK: {rounds} plane rounds, "
              f"{n} deliveries, fast == oracle")
        return True
    print(report or "\n".join(bad))
    return False


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="20/4-round sweeps")
    ap.add_argument("--smoke", action="store_true",
                    help="fast-vs-oracle trace diff only; exit 1 on "
                         "divergence")
    args = ap.parse_args()
    if args.smoke:
        sys.exit(0 if smoke() else 1)
    main(quick=args.quick)
