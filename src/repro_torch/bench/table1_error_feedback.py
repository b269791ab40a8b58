"""Paper Table 1: Fed-LT with bi-directional compression, EF on vs off.

Counterpart of the JAX package's ``benchmarks/table1_error_feedback.py``.
Monte-Carlo asymptotic optimality error  e_K = Σ_i ‖x_{i,K} − x̄‖²  for the
two quantizer settings of the paper.  Expected qualitative result (the
paper's Table 1): EF lowers the asymptotic error by ~3–9×, and the coarse
quantizer has a higher floor than the fine one.

    PYTHONPATH=src python -m repro_torch.bench.table1_error_feedback
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..core.compression import UniformQuantizer
from ..core.fedlt import optimality_error
from .common import RESULTS_DIR, make_algorithm, problem

CONFIGS = [
    ("quant L=1000 ±10", dict(levels=1000, vmin=-10.0, vmax=10.0)),
    ("quant L=10 ±1", dict(levels=10, vmin=-1.0, vmax=1.0)),
]


def run(mc_runs=3, rounds=1000, scale=1.0, verbose=True, device=None):
    rows = []
    for label, qkw in CONFIGS:
        C = UniformQuantizer(clip=True, **qkw)
        for ef, alg_name in ((False, "Algorithm 1 (no EF)"),
                             (True, "Algorithm 2 (EF)")):
            errs = []
            for mc in range(mc_runs):
                data, loss, xbar, n_agents = problem(seed=mc, scale=scale,
                                                     device=device)
                alg = make_algorithm("fedlt", loss, C, ef=ef)
                st = alg.init(torch.zeros(xbar.shape[0], device=xbar.device),
                              n_agents)
                st, _ = alg.run(st, data, rounds)
                errs.append(float(optimality_error(st.x, xbar)))
            row = dict(config=label, algorithm=alg_name,
                       mean=float(np.mean(errs)), std=float(np.std(errs)))
            rows.append(row)
            if verbose:
                print(f"{label:20s} {alg_name:22s} "
                      f"{row['mean']:.5e} ± {row['std']:.1e}")
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, "table1.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def main(quick=False, device=None):
    t0 = time.time()
    rows = run(mc_runs=1 if quick else 3, rounds=300 if quick else 1000,
               scale=0.2 if quick else 1.0, device=device)
    # derived metric: EF improvement factor on the coarse quantizer
    coarse = {r["algorithm"]: r["mean"] for r in rows
              if "L=10 " in r["config"]}
    factor = coarse["Algorithm 1 (no EF)"] / coarse["Algorithm 2 (EF)"]
    us = (time.time() - t0) * 1e6
    print(f"table1_error_feedback,{us:.0f},ef_improvement_factor={factor:.2f}")
    return factor


if __name__ == "__main__":
    main()
