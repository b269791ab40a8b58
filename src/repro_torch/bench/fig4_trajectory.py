"""Paper Fig. 4: optimality-error trajectory, EF vs no EF (coarse quantizer).

Counterpart of the JAX package's ``benchmarks/fig4_trajectory.py``: Fed-LT
under full participation with EF off and on.  Writes
``results/torch/fig4_trajectory.csv`` with columns round,no_ef,ef.

    PYTHONPATH=src python -m repro_torch.bench.fig4_trajectory
"""
from __future__ import annotations

import os
import time

import torch

from ..core.compression import UniformQuantizer
from ..core.fedlt import optimality_error
from .common import RESULTS_DIR, make_algorithm, problem


def run(rounds=800, every=10, scale=1.0, device=None):
    data, loss, xbar, n_agents = problem(seed=0, scale=scale, device=device)
    C = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    curves = {}
    for ef in (False, True):
        alg = make_algorithm("fedlt", loss, C, ef=ef)
        st = alg.init(torch.zeros(xbar.shape[0], device=xbar.device), n_agents)
        active = torch.ones((n_agents,), dtype=torch.bool, device=xbar.device)
        errs = []
        for k in range(rounds):
            st, _ = alg.round(st, data, active)
            if k % every == 0 or k == rounds - 1:
                errs.append((k, float(optimality_error(st.x, xbar))))
        curves[ef] = errs
    return curves


def main(quick=False, device=None):
    t0 = time.time()
    curves = run(rounds=200 if quick else 800, scale=0.2 if quick else 1.0,
                 device=device)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, "fig4_trajectory.csv")
    with open(path, "w") as f:
        f.write("round,no_ef,ef\n")
        for (k, e0), (_, e1) in zip(curves[False], curves[True]):
            f.write(f"{k},{e0:.6e},{e1:.6e}\n")
    final_ratio = curves[False][-1][1] / max(curves[True][-1][1], 1e-30)
    us = (time.time() - t0) * 1e6
    print(f"fig4_trajectory,{us:.0f},final_no_ef_over_ef={final_ratio:.2f}")
    return final_ratio


if __name__ == "__main__":
    main()
