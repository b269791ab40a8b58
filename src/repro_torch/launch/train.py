"""Production training launcher (deploy path).

Counterpart of ``repro.launch.train``: runs federated rounds of
``DeployFedLT`` for a selected architecture on the card (or the CPU when
``main`` is given ``device="cpu"``, as the tests do), with the JAX
launcher's flags, checkpoints of ŷ in the JAX package's format, ``--trace``
and ``--ledger``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --smoke --rounds 10 --checkpoint-dir ckpts/

``--smoke`` swaps in the reduced config; without it the full config is
used, which at stablelm-1.6b in bf16 with 2 agents holds some 23 GB of
state on the card.  Weights come from a generator seeded with 0 on the
device; agent i's tokens in round k from ``synthetic.seeded(11 + i, k)``.
``main`` returns a :class:`TrainRun` with each round's loss, seconds and
kernel launches, the checkpoints written and the last state.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import List, NamedTuple

import torch

from .. import obs
from ..checkpoint.store import save
from ..configs import ARCHS, smoke_variant
from ..core.deploy import DeployFedLT, DeployState, emit_round_series
from ..core.pytree import tree_leaves
from ..data.synthetic import make_batch, seeded, stack_batches
from ..device import resolve_device
from ..kernels import ops


class TrainRun(NamedTuple):
    losses: List[float]          # per round, the mean over agents of the last epoch's
    seconds: List[float]         # per round, host clock to the loss read back
    launches: List[dict]         # per round, kernel launches by name
    checkpoints: List[str]       # paths written (without .npz)
    state: DeployState


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-epochs", type=int, default=2)
    ap.add_argument("--gamma", type=float, default=0.02)
    ap.add_argument("--rho", type=float, default=10.0)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="stream a repro_torch.obs trace here (.jsonl / "
                         ".jsonl.gz); tail it live with "
                         "`python -m repro_torch.obs watch PATH`")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="fold the finished trace into this run ledger")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_variant(cfg)
    alg = DeployFedLT(cfg=cfg, n_epochs=args.n_epochs, gamma=args.gamma,
                      rho=args.rho, compress=not args.no_compress)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = alg.init(args.agents, generator=gen, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(state.y_hat))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M agents={args.agents} "
          f"device={dev}")

    trace_ctx = (obs.tracing(args.trace, stream_every=64,
                             scenario=cfg.name, algorithm="DeployFedLT",
                             mode="deploy", n_agents=args.agents)
                 if args.trace else contextlib.nullcontext())
    run = TrainRun([], [], [], [], None)   # holds no state while the rounds run
    with trace_ctx:
        for k in range(args.rounds):
            batch = stack_batches([make_batch(cfg, seeded(11 + i, k), args.batch,
                                              args.seq, device=dev)
                                   for i in range(args.agents)])
            before = ops.launch_counts()
            t0 = time.perf_counter()
            state, metrics = alg.round_step(state, batch)
            del batch
            loss = float(metrics["loss"])
            run.seconds.append(time.perf_counter() - t0)
            after = ops.launch_counts()
            run.launches.append({n: after[n] - before[n] for n in after
                                 if after[n] != before[n]})
            run.losses.append(loss)
            emit_round_series(k, metrics)
            print(f"round {k:5d}  loss={loss:.4f}  ({run.seconds[-1]:.1f}s)")
            if (args.checkpoint_dir and
                    ((k + 1) % args.checkpoint_every == 0
                     or k == args.rounds - 1)):
                path = os.path.join(args.checkpoint_dir, f"round_{k + 1:06d}")
                save(path, state.y_hat, step=k + 1)
                run.checkpoints.append(path)
                print(f"  checkpoint → {path}.npz")
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              "(max_memory_allocated)")
    if args.trace and args.ledger:
        from ..obs.ledger import ingest
        entry, added = ingest(args.trace, args.ledger)
        print(f"ledger: {entry['run_id']}"
              + ("" if added else " (already present)"))
    return run._replace(state=state)


if __name__ == "__main__":
    main()
