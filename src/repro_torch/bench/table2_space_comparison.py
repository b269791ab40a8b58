"""Paper Table 2: Fed-LTSat vs space-ified FedAvg/FedProx/LED/5GCS.

Counterpart of the JAX package's ``benchmarks/table2_space_comparison.py``.
All algorithms run in the SAME constellation simulation (orbit-scheduled
10%-ish participation, ISL forwarding) with the SAME agnostic EF channel,
the paper's setup, across four compressors.  Reported: mean ± std of the
asymptotic optimality error over Monte-Carlo runs.

Expected qualitative result (paper Table 2): Fed-LTSat best or near-best
in every column, with orders-of-magnitude margins under quantization.

    PYTHONPATH=src python -m repro_torch.bench.table2_space_comparison

runs ``main()``: two Monte-Carlo runs of 400 rounds per cell.  One run of
each cell is ``run(mc_runs=1)``, with ``wins`` of what it returns:

    PYTHONPATH=src python -c 'from repro_torch.bench import \
        table2_space_comparison as t; print("fedltsat_wins", t.wins(t.run(mc_runs=1)))'

Each cell's line also gives its wall time per round: the host clock
around the cell's rounds and its final e_K, which waits for the device.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..api import Experiment
from ..constellation.orbits import GroundStation, Walker
from ..core.fedlt import optimality_error
from ..sim import Engine, Scenario
from .common import COMPRESSORS, RESULTS_DIR, make_algorithm, problem

ALGOS = ["fedlt", "fedavg", "fedprox", "led", "5gcs"]
LABEL = {"fedlt": "Fed-LTSat (this paper)", "fedavg": "FedAvg",
         "fedprox": "FedProx", "led": "LED", "5gcs": "5GCS"}


def make_engine(scale=1.0) -> Engine:
    """The one engine every cell shares: Walker(100·scale sats), one
    ground station, ~10 participants per round (paper: 10%)."""
    n_sats = int(100 * scale) or 4
    walker = Walker(n_sats=n_sats, n_planes=max(2, n_sats // 10))
    return Engine(Scenario(name="table2", walker=walker,
                           stations=(GroundStation(),),
                           k_direct=4, n_relay=2))


def run_cell(engine, compressor, algo, prob, rounds, seed, *, device=None,
             **kw):
    """One cell: ``algo`` under ``compressor`` on ``prob`` (what
    :func:`problem` returns) for ``rounds`` rounds through ``Experiment``,
    e_K logged at the first and the last round.  ``kw`` goes to
    ``Experiment`` (``measure=`` for instance)."""
    data, loss, xbar, n_agents = prob
    alg = make_algorithm(algo, loss, compressor, ef=True)
    exp = Experiment(None, alg, engine=engine, compressor=compressor,
                     device=device, **kw)
    st = exp.init(torch.zeros(xbar.shape[0]), n_agents)
    return exp.run(st, data, rounds, seed, log_every=rounds,
                   error_fn=lambda s: optimality_error(s.x, xbar))


def run(mc_runs=2, rounds=400, scale=1.0, verbose=True, device=None):
    engine = make_engine(scale)
    table = {}
    for comp_name, C in COMPRESSORS.items():
        for algo in ALGOS:
            errs, secs = [], 0.0
            for mc in range(mc_runs):
                prob = problem(seed=mc, scale=scale, device=device)
                t0 = time.perf_counter()
                res = run_cell(engine, C, algo, prob, rounds, 200 + mc,
                               device=device)
                errs.append(float(optimality_error(res.state.x, prob[2])))
                secs += time.perf_counter() - t0
            table[(comp_name, algo)] = (float(np.mean(errs)), float(np.std(errs)))
            if verbose:
                m, s = table[(comp_name, algo)]
                print(f"{comp_name:12s} {LABEL[algo]:24s} {m:.4e} ± {s:.1e}  "
                      f"{1e3 * secs / (mc_runs * rounds):.3f} ms/round")
    return table


def wins(table) -> int:
    """In how many compressor columns Fed-LTSat is the best algorithm."""
    return sum(min(ALGOS, key=lambda a: table[(comp, a)][0]) == "fedlt"
               for comp in COMPRESSORS)


def main(quick=False, device=None):
    t0 = time.time()
    table = run(mc_runs=1 if quick else 2, rounds=150 if quick else 400,
                scale=0.2 if quick else 1.0, device=device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, "table2.json"), "w") as f:
        json.dump({f"{c}|{a}": v for (c, a), v in table.items()}, f, indent=2)
    w = wins(table)
    us = (time.time() - t0) * 1e6
    print(f"table2_space_comparison,{us:.0f},fedltsat_wins={w}/"
          f"{len(COMPRESSORS)}")
    return w


if __name__ == "__main__":
    main()
