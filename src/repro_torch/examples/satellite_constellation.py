"""Fed-LTSat in a simulated LEO constellation (paper Algorithm 3).

Counterpart of the JAX package's ``examples/satellite_constellation.py``.
A 100-satellite Walker constellation over a polar ground station, driven
through the port's discrete-event engine: the contact-plan scheduler picks
~12 satellites per round (direct GS windows + multi-hop ISL-forwarded
neighbours).  Compares Fed-LTSat against space-ified FedAvg under coarse
quantization + EF in synchronous mode (Fed-LTSat on the fused
compress→EF→pack uplink, ``FedLT(fused_uplink=True)``: one kernel launch
per leaf over the whole agent stack; bytes accounted per contact-window
cohort, ``measure="cohort"``), then runs Fed-LTSat in buffered-async
(FedBuff-style, staleness-weighted) mode on the dual-station scenario, and
finally over the ``lossy-uplink`` channel scenario with loss-robust error
feedback.  N=100, m=200, d=100, 120 rounds.

Every run records an obs trace (``results/torch/constellation_<name>.jsonl``)
and the report printed for it is ``obs.render_rounds`` over the traced
``fl_round`` records that evaluated the error.  Read a trace back with
``repro_torch.obs.load(path)`` and ``repro_torch.obs.summarize``.

Run (on the card):  PYTHONPATH=src python -m repro_torch.examples.satellite_constellation
"""
from __future__ import annotations

import os

import torch

from .. import obs
from ..api import Experiment
from ..bench.common import RESULTS_DIR
from ..core.baselines import FedAvg
from ..core.compression import UniformQuantizer
from ..core.error_feedback import EFChannel
from ..core.fedlt import FedLT, optimality_error
from ..data.logistic import generate, make_local_loss, solve_global
from ..device import resolve_device

N_AGENTS, M, DIM = 100, 200, 100


def setup(device=None):
    """The example's problem, quantizer and its two algorithms:
    ``(data, x_star, quant, {"Fed-LTSat": ..., "FedAvg(space)": ...})``."""
    data, _ = generate(0, n_agents=N_AGENTS, m=M, dim=DIM, device=device)
    loss = make_local_loss(eps=50.0, n_agents=N_AGENTS)
    x_star = solve_global(data, eps=50.0)
    quant = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    up, down = EFChannel(quant), EFChannel(quant)
    algs = {
        # fused_uplink=True: the compress→EF→pack chain runs as ONE kernel
        # over the whole agent stack (EFChannel.send_fused)
        "Fed-LTSat": FedLT(loss=loss, n_epochs=10, gamma=0.005, rho=20.0,
                           uplink=up, downlink=down, fused_uplink=True),
        "FedAvg(space)": FedAvg(loss=loss, n_epochs=10, gamma=0.05,
                                uplink=up, downlink=down),
    }
    return data, x_star, quant, algs


# (name, algorithm, scenario, seed, Experiment options)
RUNS = (
    # measure="cohort": bytes_up accounted from the actually-transmitted
    # wire state, batched per contact-window cohort
    ("Fed-LTSat", "Fed-LTSat", "walker-kiruna", 2, dict(measure="cohort")),
    ("FedAvg(space)", "FedAvg(space)", "walker-kiruna", 2,
     dict(measure="cohort")),
    # buffered-async: two ground stations, staleness-weighted aggregation
    ("async (Fed-LTSat, dual-station)", "Fed-LTSat", "dual-station", 3,
     dict(mode="async", buffer_size=10, staleness_alpha=0.5)),
    # lossy uplink: 10% segment erasures with selective-repeat ARQ; lost
    # updates keep their EF residual (loss-robust EF) so their content
    # telescopes into the next successful pass
    ("lossy (Fed-LTSat, loss-robust EF)", "Fed-LTSat", "lossy-uplink", 4,
     dict(measure="cohort")),
)


def traced_run(name, alg, scenario, seed, kw, data, x_star, quant, rounds,
               device=None, out_dir=RESULTS_DIR):
    """One ``Experiment.run``, traced to ``out_dir``; returns the result
    and the obs per-round table over the rounds that evaluated the error."""
    slug = "".join(c for c in name.split(" ")[0].lower() if c.isalnum())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"constellation_{slug}.jsonl")
    exp = Experiment.from_scenario(scenario, algorithm=alg, compressor=quant,
                                   meta=dict(example=name), device=device, **kw)
    st = exp.init(torch.zeros((DIM,)), N_AGENTS)
    res = exp.run(st, data, rounds, seed,
                  error_fn=lambda s: optimality_error(s.x, x_star),
                  log_every=20, trace=path)
    evaluated = [r for r in res.records if r.get("kind") == "fl_round"
                 and r.get("error") is not None]
    return res, path, obs.render_rounds(evaluated)


def main(rounds=120, device=None, out_dir=RESULTS_DIR):
    device = resolve_device(device)
    data, x_star, quant, algs = setup(device)
    for name, alg_name, scenario, seed, kw in RUNS:
        _, path, table = traced_run(name, algs[alg_name], scenario, seed, kw,
                                    data, x_star, quant, rounds, device, out_dir)
        print(f"\n=== {name} (trace: {path}) ===")
        print(table)


if __name__ == "__main__":
    main()
