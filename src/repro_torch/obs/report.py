"""The canonical convergence scenarios and their gate.

Counterpart of the convergence-gate part of ``repro.obs.report``: the
four ``CANONICAL`` scenarios that the committed ``CONV_reference.json``
pins, :func:`run_canonical` to run one of them on the port, and
:func:`gate_records` to hold a run's curves against the reference (e_K
at most ``1 + tol`` times the reference at every sampled round, the
final ``bytes_up`` within ``±tol_bytes``).  The report tables, ``watch``
and the CLI are not ported.

The reference curves were drawn with ``jax.random`` from seed
``CANONICAL_SEED``, which the port cannot reproduce.  ``run_canonical``
therefore takes the problem as an optional ``problem=(data, x_star)``;
without it the port's own :func:`repro_torch.data.logistic.generate`
draws one from ``CANONICAL_SEED``.  ``bytes_up`` does not depend on the
draw; e_K does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .summary import extract_series

DEFAULT_TOL = 0.25        # e_K may degrade by at most 25% at any round
DEFAULT_TOL_BYTES = 0.01  # byte accounting is deterministic: ±1% only

# the canonical convergence scenarios (name → runner config), copied from
# the JAX package.  Deterministic: fixed seeds, fixed problem sizes,
# deterministic engine timelines.  The FedLT hyperparameters sit where
# error feedback visibly drives convergence under the 10-level quantizer.
CANONICAL: Dict[str, dict] = {
    "sync-lossless": dict(
        scenario="walker-kiruna", mode="sync", rounds=30, loss=None,
        gamma=0.02, rho=2.0),
    "sync-lossy-robust-ef": dict(
        scenario="walker-kiruna", mode="sync", rounds=60, loss=0.3,
        gamma=0.02, rho=2.0),
    "async-mega-1000": dict(
        scenario="mega-1000", mode="async", rounds=8, loss=None,
        n_agents=1000, dim=8, m=16, buffer_size=64,
        gamma=0.02, rho=2.0),
    # scale + erasures + radiation-upset crashes + station blackouts,
    # rounds closed by a quorum deadline
    "sync-mega-chaos": dict(
        scenario="mega-1000-chaos", mode="sync", rounds=8, loss=None,
        n_agents=1000, dim=8, m=16, deadline=45.0, quorum=0.7,
        gamma=0.02, rho=2.0),
}
CANONICAL_SEED = 7


def run_canonical(name: str, *, ef: bool = True, loss_robust: bool = True,
                  rounds: Optional[int] = None, problem=None,
                  device=None) -> List[dict]:
    """Run one canonical convergence scenario under a fresh in-memory
    trace; returns the trace records.

    ``problem=(data, x_star)`` supplies the logistic problem (a data dict
    of arrays or tensors and the optimum); without it the port draws one
    from ``CANONICAL_SEED``.  ``ef=False`` / ``loss_robust=False``
    reproduce the silent failure modes the gate exists to catch.  Runs on
    the card unless ``device="cpu"``."""
    import torch

    from ..api import Experiment
    from ..core.compression import UniformQuantizer
    from ..core.error_feedback import EFChannel
    from ..core.fedlt import FedLT, optimality_error
    from ..data.logistic import generate, make_local_loss, solve_global
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = CANONICAL[name]
    n_agents = cfg.get("n_agents", 100)
    dim, m = cfg.get("dim", 32), cfg.get("m", 40)
    rounds = rounds if rounds is not None else cfg["rounds"]
    if problem is None:
        data, _ = generate(CANONICAL_SEED, n_agents=n_agents, m=m, dim=dim,
                           device=dev)
        x_star = solve_global(data, eps=50.0)
    else:
        data, x_star = problem
        x_star = torch.as_tensor(x_star).to(dev)
    loss_fn = make_local_loss(eps=50.0, n_agents=n_agents)
    quant = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    alg = FedLT(loss=loss_fn, n_epochs=10, gamma=cfg["gamma"],
                rho=cfg["rho"],
                uplink=EFChannel(quant, enabled=ef),
                downlink=EFChannel(quant, enabled=ef))
    channel = None
    if cfg["loss"] is not None:
        from ..channel import ChannelModel, SelectiveRepeatARQ
        channel = ChannelModel(
            loss=cfg["loss"],
            arq=SelectiveRepeatARQ(seg_bytes=4096, max_rounds=1))
    runner_kw: dict = dict(compressor=quant, channel=channel,
                           loss_robust=loss_robust)
    if cfg.get("deadline") is not None:
        runner_kw.update(deadline=cfg["deadline"],
                         quorum=cfg.get("quorum", 0.0))
    if cfg["mode"] == "async":
        runner_kw.update(mode="async", buffer_size=cfg["buffer_size"],
                         staleness_alpha=0.5)
    exp = Experiment(cfg["scenario"], alg, seed=CANONICAL_SEED,
                     meta=dict(canonical=name), device=dev, **runner_kw)
    st = exp.init(torch.zeros(dim), n_agents)
    err = lambda s: float(optimality_error(s.x, x_star))  # noqa: E731
    return exp.run(st, data, rounds, 100 + CANONICAL_SEED,
                   error_fn=err, log_every=1, trace=True).records


def gate_records(name: str, records: Sequence[dict], reference: dict,
                 tol: Optional[float] = None,
                 tol_bytes: Optional[float] = None) -> List[str]:
    """Compare one run's curves to the committed reference; returns
    failure messages (empty = gate passes), each localized to the
    scenario, round, and metric that regressed."""
    ref = reference["scenarios"].get(name)
    if ref is None:
        return [f"{name}: no reference curve in the reference file "
                f"(known: {sorted(reference['scenarios'])})"]
    tol = reference.get("tol", DEFAULT_TOL) if tol is None else tol
    tol_bytes = (reference.get("tol_bytes", DEFAULT_TOL_BYTES)
                 if tol_bytes is None else tol_bytes)
    series = extract_series(records)
    fresh = series.get("e_K", {"steps": [], "values": []})
    fresh_at = dict(zip(fresh["steps"], fresh["values"]))
    bad: List[str] = []
    for step, rv in zip(ref["e_K"]["steps"], ref["e_K"]["values"]):
        fv = fresh_at.get(step)
        if fv is None:
            bad.append(f"{name}: e_K sample missing at round {step} "
                       f"(reference has one)")
        elif fv > rv * (1.0 + tol):
            bad.append(f"{name}: e_K degraded at round {step}: "
                       f"{fv:.6g} > reference {rv:.6g} × (1+{tol:g})")
    bu = series.get("bytes_up", {"values": []})["values"]
    fresh_bytes = bu[-1] if bu else None
    ref_bytes = ref.get("bytes_up")
    if ref_bytes is not None:
        if fresh_bytes is None:
            bad.append(f"{name}: bytes_up series missing")
        elif abs(fresh_bytes - ref_bytes) > ref_bytes * tol_bytes:
            bad.append(f"{name}: bytes_up drifted: {fresh_bytes:.0f} vs "
                       f"reference {ref_bytes:.0f} (±{tol_bytes:.0%})")
    return bad
