"""End-to-end driver: federated training of a transformer LM (deploy path).

Counterpart of the JAX package's ``examples/train_federated_lm.py``.  Each
"satellite" holds its own heterogeneous token stream (per-agent Markov
language); one round = N_e local prox-epochs + quantized/EF uplink +
aggregation + quantized/EF downlink, the same ``DeployFedLT.round_step``
that ``launch/train.py`` drives.

Presets:
  smoke (default)  4.7M parameters, float32: a CPU run in minutes
  100m             138M parameters, bf16: the "train a ~100M model" driver,
                   same code path, sized for the card

Run (on the card):  PYTHONPATH=src python -m repro_torch.examples.train_federated_lm --rounds 20
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.deploy import DeployFedLT
from ..core.pytree import tree_leaves, tree_map
from ..data.synthetic import make_batch, seeded, stack_batches
from ..device import resolve_device
from ..models.config import ModelConfig

PRESETS = {
    "smoke": ModelConfig(
        name="fed-lm-smoke", arch_type="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=1024, vocab_size=2048, max_seq=512,
        chunk_size=64, tie_embeddings=True, dtype="float32"),
    "100m": ModelConfig(
        name="fed-lm-100m", arch_type="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32000, max_seq=2048,
        tie_embeddings=True, dtype="bfloat16"),
}


def main(argv=None, device=None) -> list:
    """Run the driver; returns each round's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=sorted(PRESETS))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4, help="per-agent batch")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-epochs", type=int, default=2)
    ap.add_argument("--no-compress", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = PRESETS[args.preset]
    alg = DeployFedLT(cfg=cfg, n_epochs=args.n_epochs, gamma=0.02, rho=10.0,
                      compress=not args.no_compress, levels=1023,
                      vmin=-0.5, vmax=0.5)
    # weights drawn on the CPU from seed 0 and moved: the card and the CPU
    # train the same model, so their losses can be held against each other
    state = alg.init(args.agents, generator=torch.Generator().manual_seed(0), device="cpu")
    state = state._replace(**{f: tree_map(lambda t: t.to(dev), getattr(state, f))
                              for f in ("x", "z", "c_up", "y_hat", "c_down")})
    n_params = sum(x.numel() for x in tree_leaves(state.y_hat))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  "
          f"agents={args.agents}  compress={not args.no_compress}")

    losses = []
    for k in range(args.rounds):
        batch = stack_batches([make_batch(cfg, seeded(7 + i, k), args.batch, args.seq,
                                          device=dev) for i in range(args.agents)])
        t0 = time.time()
        state, metrics = alg.round_step(state, batch)
        losses.append(float(metrics["loss"]))
        print(f"round {k:4d}  local-loss={losses[-1]:.4f}  ({time.time()-t0:.1f}s)")

    print("done — coordinator model ŷ is state.y_hat (servable).")
    return losses


if __name__ == "__main__":
    main()
