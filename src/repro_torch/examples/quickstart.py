"""Quickstart: communication-efficient federated learning in 60 lines.

Counterpart of the JAX package's ``examples/quickstart.py``.  Trains the
paper's regularized logistic regression over 50 agents with
bi-directional uniform quantization + error feedback (Algorithm 2) vs the
no-EF ablation (Algorithm 1), recording each run as a ``repro_torch.obs``
trace: per-round ``fl_round`` events plus byte counters, flushed to
``<out_dir>/quickstart_<variant>.jsonl`` and summarized with the obs
renderer (the table ``python -m repro_torch.obs summarize`` prints).

The data come from the port's own generator, so the error curves are not
the JAX package's numbers, only their shape; the bytes on the wire are
the same, since they depend on the quantizer alone.

Run (on the card):  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import os

import torch

from .. import obs
from ..bench.common import RESULTS_DIR
from ..constellation.links import message_bytes
from ..core.compression import UniformQuantizer, wire_index_bits
from ..core.error_feedback import EFChannel
from ..core.fedlt import FedLT, optimality_error
from ..data.logistic import generate, make_local_loss, solve_global
from ..device import resolve_device

N_AGENTS, DIM, ROUNDS = 50, 50, 400


def main(rounds: int = ROUNDS, device=None, out_dir: str = RESULTS_DIR) -> dict:
    """Run both variants; returns ``{"alg1_no_ef": records, "alg2_ef":
    records}``, each run's traced records."""
    device = resolve_device(device)
    data, _ = generate(0, n_agents=N_AGENTS, m=200, dim=DIM, device=device)
    loss = make_local_loss(eps=50.0, n_agents=N_AGENTS)
    x_star = solve_global(data, eps=50.0)

    quant = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    # nominal per-agent uplink: DIM values at ceil(log2(levels+1)) bits
    msg = message_bytes(DIM, wire_index_bits(quant.levels))
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for ef in (False, True):
        alg = FedLT(loss=loss, n_epochs=10, gamma=0.005, rho=20.0,
                    uplink=EFChannel(quant, enabled=ef),
                    downlink=EFChannel(quant, enabled=ef))
        state = alg.init(torch.zeros((DIM,), device=device), N_AGENTS)
        active = torch.ones((N_AGENTS,), dtype=torch.bool, device=device)
        name = "alg2_ef" if ef else "alg1_no_ef"
        path = os.path.join(out_dir, f"quickstart_{name}.jsonl")
        with obs.tracing(path, example="quickstart", ef=ef) as trc:
            up = trc.metrics.counter("bytes_up")
            for k in range(rounds):
                state, _ = alg.round(state, data, active)
                up.add(msg * N_AGENTS)
                if k % 80 == 0 or k == rounds - 1:
                    err = float(optimality_error(state.x, x_star))
                    trc.event("fl_round", round=k, t=float(k),
                              bytes_up=up.total, n_active=N_AGENTS,
                              error=err)
            records = trc.records()
        print(f"\n=== Algorithm {'2 (with EF)' if ef else '1 (no EF)'} "
              f"(trace: {path}) ===")
        print(obs.render_rounds(records))
        out[name] = records
    return out


if __name__ == "__main__":
    main()
