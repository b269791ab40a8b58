"""Shared benchmark setup: the paper's experimental problem + tuned configs.

Counterpart of the JAX package's ``benchmarks/common.py``.  The data are
drawn from a ``torch.Generator`` seeded with ``seed`` on the run's device
(not the JAX package's numbers), and x̄ comes from the port's Newton
solve.  Results go under ``results/torch/``, beside the JAX package's
``results/``.
"""
from __future__ import annotations

import os

from ..core.baselines import LED, FedAvg, FedProx, FiveGCS
from ..core.compression import RandD, UniformQuantizer
from ..core.error_feedback import EFChannel
from ..core.fedlt import FedLT
from ..data.logistic import generate, make_local_loss, solve_global

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "torch"))

# paper §3: ε=50, m_i=500, n=100, N=100, N_e=10; γ, ρ grid-tuned.  The tuned
# point sits in the slow local-training regime where EF wins.
PAPER = dict(n_agents=100, m=500, dim=100, eps=50.0)
TUNED = dict(n_epochs=10, gamma=0.005, rho=20.0)

COMPRESSORS = {
    "quant_fine":   UniformQuantizer(levels=1000, vmin=-10, vmax=10, clip=True),
    "quant_coarse": UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True),
    "rand_0.8":     RandD(fraction=0.8),
    "rand_0.2":     RandD(fraction=0.2),
}


def assert_fast_oracle_equivalent(eng_fast, eng_oracle, msg_bytes, *,
                                  rounds=3, async_deliveries=100):
    """Drive both engines through the same sync trajectory and an async
    stream and assert identical Delivery timelines — the fast engine's
    acceptance contract, shared by ``sim_scale.bench_fast_round`` and
    ``profile_round --check-equivalence`` so the contract lives in ONE
    place.  Delivery is an eq dataclass: ``==`` compares every field
    (engine records always carry finite windows, so NaN can't defeat the
    comparison).  Raises ``AssertionError`` on the first difference, also
    under ``python -O``.  Returns the fast engine's RoundResults; both
    engines come back warm.
    """
    t_f = t_o = 0.0
    results = []
    for r in range(rounds):
        rf = eng_fast.run_round(t_f, msg_bytes)
        ro = eng_oracle.run_round(t_o, msg_bytes)
        if not (rf.deliveries == ro.deliveries and rf.duration == ro.duration
                and (rf.mask == ro.mask).all()):
            raise AssertionError(
                f"fast path diverged from the heapq oracle (sync round {r})")
        t_f += rf.duration
        t_o += ro.duration
        results.append(rf)
    d_f = eng_fast.run_async(0.0, msg_bytes, n_deliveries=async_deliveries)
    d_o = eng_oracle.run_async(0.0, msg_bytes, n_deliveries=async_deliveries)
    if d_f != d_o:
        raise AssertionError("fast path diverged from the heapq oracle (async)")
    return results


def problem(seed=0, scale=1.0, device=None):
    """(data, loss, x̄, n_agents) of the paper's problem, cut by ``scale``
    in agents and samples per agent; on the card unless ``device``."""
    n_agents = int(PAPER["n_agents"] * scale) or 4
    m = int(PAPER["m"] * scale) or 16
    data, _ = generate(seed, n_agents=n_agents, m=m, dim=PAPER["dim"],
                       device=device)
    loss = make_local_loss(eps=PAPER["eps"], n_agents=n_agents)
    xbar = solve_global(data, eps=PAPER["eps"])
    return data, loss, xbar, n_agents


def logistic_problem(seed=0, *, n_agents, m, dim, device=None):
    """(data, loss, x̄) of the logistic problem (ε=50) at these sizes, the
    problem of the lossy-EF, fault-tolerance and plane-aggregation tables;
    on the card unless ``device``."""
    data, _ = generate(seed, n_agents=n_agents, m=m, dim=dim, device=device)
    return (data, make_local_loss(eps=50.0, n_agents=n_agents),
            solve_global(data, eps=50.0))


def make_algorithm(name, loss, compressor, ef=True, **overrides):
    up, down = EFChannel(compressor, enabled=ef), EFChannel(compressor, enabled=ef)
    kw = dict(TUNED)
    kw.update(overrides)
    rho = kw.pop("rho")
    if name == "fedlt":
        return FedLT(loss=loss, rho=rho, uplink=up, downlink=down, **kw)
    if name == "fedavg":
        return FedAvg(loss=loss, n_epochs=kw["n_epochs"], gamma=0.05,
                      uplink=up, downlink=down)
    if name == "fedprox":
        return FedProx(loss, n_epochs=kw["n_epochs"], gamma=0.05, prox_mu=1.0,
                       uplink=up, downlink=down)
    if name == "led":
        return LED(loss=loss, n_epochs=kw["n_epochs"], gamma=0.01,
                   uplink=up, downlink=down)
    if name == "5gcs":
        return FiveGCS(loss=loss, n_epochs=kw["n_epochs"], gamma=0.05,
                       gamma_p=1.0, uplink=up, downlink=down)
    raise ValueError(name)
