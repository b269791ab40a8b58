"""Fault tolerance: quorum deadlines + head failover + loss-robust EF
vs a naive deadline-less baseline (robustness-subsystem table).

Counterpart of the JAX package's ``benchmarks/table_fault_tolerance.py``.
Sweeps the per-flight crash rate of a :class:`repro_torch.faults.
FaultModel` on a heterogeneous-compute plane-aggregation scenario (15-60 s
compute spread, so round deadlines bite; 15 % of head uplinks fail
mid-convergecast, so failover runs) and compares two arms of Fed-LT at
equal round counts:

  * **quorum+failover+robust-EF**: rounds close at a 180 s deadline once
    60 % of the attempted update-weight has landed; stragglers and
    failover collateral revert into their EF residuals
    (``loss_robust=True``); crashed satellites re-sync their residual to
    zero (both arms share that);
  * **naive restart**: no deadline and non-robust EF: whatever a crash or
    dead head destroys is discharged from the residual and vanishes.

Expected qualitative result: at every crash rate ≥ 5 % the robust arm
reaches a strictly lower e_K than the naive one at the same number of
rounds, in less simulated time and with no more uplink bytes.

Every arm runs under a trace folded into a run ledger
(``results/torch/ledger_fault_tolerance.jsonl``); the printed table and
the dominance gate are rendered only from the ledger entries
(:func:`repro_torch.obs.report.fault_tolerance_rows`).  Each printed row
also gives the arm's wall time per round.  Runs on the card:

    PYTHONPATH=src python -m repro_torch.bench.table_fault_tolerance [--quick]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..api import Experiment
from ..core.error_feedback import EFChannel
from ..core.fedlt import FedLT, optimality_error
from ..faults import FaultModel
from ..obs.ledger import load_ledger
from ..obs.report import fault_tolerance_rows
from ..sim import Engine, get_scenario
from .common import COMPRESSORS, RESULTS_DIR, TUNED, logistic_problem

LEDGER = os.path.join(RESULTS_DIR, "ledger_fault_tolerance.jsonl")

ROBUST = "quorum+failover+robust-EF"
NAIVE = "naive restart"
ARMS = [
    # (label, loss_robust, deadline, quorum)
    (ROBUST, True, 180.0, 0.6),
    (NAIVE, False, None, 0.0),
]
HEAD_FAILURE_RATE = 0.15
FAILOVER_TIMEOUT = 60.0
RUN_SEED = 100            # an arm's run seed is RUN_SEED + the sweep's seed


def _scenario():
    """plane-agg-walker with the hetero-compute 15-60 s spread: slow
    planes straggle, so the deadline has something to cut."""
    base = get_scenario("plane-agg-walker")
    spread = 15.0 + 45.0 * (np.arange(base.walker.n_sats) % 5) / 4.0
    return dataclasses.replace(base, name="fault-tolerance-bench",
                               compute_time=spread)


def render_row(row: dict) -> str:
    return (f"crash={row['crash_rate']:4.2f}  {row['arm']:26s} "
            f"e_K={row['error']:.5f}  t_sim={row['t_sim']:9.0f}s  "
            f"lost={row['lost']:5d}  up={row['bytes_up'] / 1e3:7.1f}kB")


def make_arm(loss, crash_rate, arm, engine, *, device=None, meta=None):
    """One arm of the sweep at ``crash_rate``: Fed-LT with the coarse
    quantizer in both EF channels, the arm's deadline, quorum and EF
    semantics, and the rate's :class:`FaultModel`, through ``engine``.
    Its run takes ``RUN_SEED + seed``."""
    C = COMPRESSORS["quant_coarse"]
    _, robust, deadline, quorum = arm
    fm = FaultModel(crash_rate=crash_rate,
                    head_failure_rate=HEAD_FAILURE_RATE,
                    failover_timeout=FAILOVER_TIMEOUT)
    alg = FedLT(loss=loss, uplink=EFChannel(C), downlink=EFChannel(C),
                **TUNED)
    return Experiment(None, alg, engine=engine, compressor=C, faults=fm,
                      deadline=deadline, quorum=quorum, loss_robust=robust,
                      device=device, meta=meta or {})


def run(crash_rates, rounds=300, n_agents=100, dim=100, m=100, seed=0,
        verbose=True, ledger_path=LEDGER, device=None):
    data, loss, x_star = logistic_problem(seed, n_agents=n_agents, m=m,
                                          dim=dim, device=device)
    err = lambda s: float(optimality_error(s.x, x_star))  # noqa: E731

    # one engine for the whole sweep, as the reference's; each arm installs
    # its FaultModel through the facade (Engine.install_faults), and fault
    # draws are counter-based.  The contact plan's horizon carries over
    # from arm to arm, and rounds depend on it, so an arm's run depends on
    # the arms before it (ROADMAP Queue 3)
    engine = Engine(_scenario())
    run_ids, ms = [], []
    for cr in crash_rates:
        for arm in ARMS:
            exp = make_arm(loss, cr, arm, engine, device=device,
                           meta=dict(arm=arm[0], crash_rate=cr,
                                     rounds=rounds, seed=seed,
                                     quorum=arm[3]))
            st = exp.init(torch.zeros(dim), n_agents)
            t0 = time.perf_counter()
            res = exp.run(st, data, rounds, RUN_SEED + seed, error_fn=err,
                          log_every=rounds, ledger=ledger_path)
            ms.append(1e3 * (time.perf_counter() - t0) / rounds)
            run_ids.append(res.run_id)
    # ---- reporting: only from the ledger --------------------------------
    by_id = {e["run_id"]: e for e in load_ledger(ledger_path)}
    entries = [by_id[r] for r in run_ids]     # sweep order
    rows = fault_tolerance_rows(entries)
    if verbose:
        for row, t in zip(rows, ms):
            print(f"{render_row(row)}  {t:.3f} ms/round")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR,
                           "table_fault_tolerance.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def main(quick=False, device=None):
    t0 = time.time()
    crash_rates = [0.0, 0.05, 0.1]
    rows = run(crash_rates, rounds=120 if quick else 300, device=device)
    # the acceptance gate: at every crash rate >= 5% the robust arm
    # strictly beats the naive baseline on e_K at equal rounds, without
    # spending more uplink bytes (rows come from the ledger, see run())
    by = {(r["crash_rate"], r["arm"]): r for r in rows}
    high = [cr for cr in crash_rates if cr >= 0.05]
    dominates = all(
        by[(cr, ROBUST)]["error"] < by[(cr, NAIVE)]["error"]
        and by[(cr, ROBUST)]["bytes_up"] <= 1.05 * by[(cr, NAIVE)]["bytes_up"]
        for cr in high)
    ratio = (sum(by[(cr, NAIVE)]["error"] / by[(cr, ROBUST)]["error"]
                 for cr in high) / len(high))
    speedup = (sum(by[(cr, NAIVE)]["t_sim"] / by[(cr, ROBUST)]["t_sim"]
                   for cr in high) / len(high))
    us = (time.time() - t0) * 1e6
    print(f"table_fault_tolerance,{us:.0f},robust_dominates={int(dominates)},"
          f"mean_naive_over_robust={ratio:.2f},mean_tsim_speedup={speedup:.2f}")
    return dominates


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="120-round sweep")
    main(quick=ap.parse_args().quick)
