"""Loss-robust error feedback over a lossy uplink (channel-subsystem table).

Counterpart of the JAX package's ``benchmarks/table_lossy_ef.py``.  Sweeps
the segment-erasure probability of a :class:`repro_torch.channel.
ChannelModel` on the ``walker-kiruna`` scenario and compares three arms
of Fed-LT under coarse quantization:

  * **EF (loss-robust)**: Algorithm 2 + ``loss_robust=True``: a destroyed
    uplink reverts the satellite's EF residual, so the cached content
    telescopes into its next successful transmission;
  * **EF (naive)**: Algorithm 2 with the cache discharged into the lost
    wire (``loss_robust=False``);
  * **no EF**: Algorithm 1 (``EFChannel(enabled=False)``).

Expected qualitative result: the loss-robust EF arm strictly dominates
the no-EF arm at every loss rate ≥ 10 %.  One segment per message
(``seg_bytes`` ≥ message size, ``max_rounds=1``) makes the segment-loss
rate the update-loss rate.

Every arm runs under a trace folded into a run ledger
(``results/torch/ledger_lossy_ef.jsonl``); the printed table, the JSON
dump and the CSV line are rendered only from the ledger entries
(:func:`repro_torch.obs.report.lossy_ef_rows`).  Each printed row also
gives the arm's wall time per round (host clock around ``Experiment.run``,
whose last e_K waits for the device).  Runs on the card:

    PYTHONPATH=src python -m repro_torch.bench.table_lossy_ef [--quick]
    PYTHONPATH=src python -m repro_torch.obs report --ledger \\
        results/torch/ledger_lossy_ef.jsonl --frontier
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..api import Experiment
from ..channel import ChannelModel, SelectiveRepeatARQ
from ..core.compression import UniformQuantizer
from ..core.error_feedback import EFChannel
from ..core.fedlt import FedLT, optimality_error
from ..obs.ledger import load_ledger
from ..obs.report import lossy_ef_rows
from ..sim import Engine, get_scenario
from .common import RESULTS_DIR, TUNED, logistic_problem

ARMS = [
    ("EF (loss-robust)", True, True),
    ("EF (naive)", True, False),
    ("no EF", False, False),
]

LEDGER = os.path.join(RESULTS_DIR, "ledger_lossy_ef.jsonl")


def render_row(row: dict) -> str:
    return (f"p={row['loss_rate']:4.2f}  {row['arm']:18s} "
            f"e_K={row['error']:.5f}  "
            f"lost={row['lost']:5d}/{row['lost'] + row['received']}  "
            f"up={row['bytes_up'] / 1e3:7.1f}kB")


def run(loss_rates, rounds=1500, n_agents=100, dim=100, m=100, seed=0,
        verbose=True, ledger_path=LEDGER, device=None):
    data, loss, x_star = logistic_problem(seed, n_agents=n_agents, m=m,
                                          dim=dim, device=device)
    C = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    err = lambda s: float(optimality_error(s.x, x_star))  # noqa: E731

    # one engine for the whole sweep: rounds are pure functions of
    # (scenario, seed, t0), so arms cannot contaminate each other, and the
    # contact plan and the fast path's cached ARQ plans are built once
    engine = Engine(get_scenario("walker-kiruna"))
    run_ids, ms = [], []
    for p in loss_rates:
        # one segment per update, no retransmission: the segment-loss rate
        # is the update-loss rate (the sweep axis)
        ch = ChannelModel(loss=p, arq=SelectiveRepeatARQ(seg_bytes=4096,
                                                         max_rounds=1))
        for arm, ef, robust in ARMS:
            alg = FedLT(loss=loss, uplink=EFChannel(C, enabled=ef),
                        downlink=EFChannel(C, enabled=ef), **TUNED)
            exp = Experiment(None, alg, engine=engine, compressor=C,
                             channel=ch, loss_robust=robust, device=device,
                             meta=dict(arm=arm, loss_rate=p, rounds=rounds,
                                       seed=seed))
            st = exp.init(torch.zeros(dim), n_agents)
            t0 = time.perf_counter()
            res = exp.run(st, data, rounds, 100 + seed, error_fn=err,
                          log_every=rounds, ledger=ledger_path)
            ms.append(1e3 * (time.perf_counter() - t0) / rounds)
            run_ids.append(res.run_id)
    # ---- reporting: only from the ledger --------------------------------
    by_id = {e["run_id"]: e for e in load_ledger(ledger_path)}
    entries = [by_id[r] for r in run_ids]     # sweep order
    rows = lossy_ef_rows(entries)
    if verbose:
        for row, t in zip(rows, ms):
            print(f"{render_row(row)}  {t:.3f} ms/round")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, "table_lossy_ef.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def main(quick=False, device=None):
    t0 = time.time()
    loss_rates = [0.0, 0.1, 0.2] if quick else [0.0, 0.05, 0.1, 0.2, 0.3]
    rows = run(loss_rates, rounds=500 if quick else 1500, device=device)
    # derived metric: does loss-robust EF strictly dominate no-EF at every
    # loss rate >= 10%?  (rows come from the ledger, see run())
    by = {(r["loss_rate"], r["arm"]): r["error"] for r in rows}
    high = [p for p in loss_rates if p >= 0.1]
    dominates = all(by[(p, "EF (loss-robust)")] < by[(p, "no EF")]
                    for p in high)
    ratio = (sum(by[(p, "no EF")] / by[(p, "EF (loss-robust)")]
                 for p in high) / len(high))
    us = (time.time() - t0) * 1e6
    print(f"table_lossy_ef,{us:.0f},ef_dominates={int(dominates)},"
          f"mean_noef_over_ef={ratio:.2f}")
    return dominates


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="3-point sweep, 500 rounds")
    main(quick=ap.parse_args().quick)
