"""Synthetic data pipeline for the LM architectures.

Counterpart of ``repro.data.synthetic``: deterministic per-agent token
streams (seeded by agent id and round) so the federated run is
reproducible.  The "task" is a learnable synthetic language: tokens follow
a random Markov chain over 64 hidden states per stream (heterogeneous
across agents, the federated setting), so models can reduce their loss
and training curves mean something.

The streams are drawn from a ``torch.Generator`` on the CPU and the
batches moved to their device (the card unless ``device="cpu"``), so a
seed gives the same tokens on the card and off it.  They are not the JAX
package's numbers (``jax.random`` has no counterpart here), only its
distribution.  :func:`_mrope_positions` is
deterministic and equals the JAX package's.

For VLM/audio stubs, :func:`make_batch` also emits the precomputed
frame/patch embeddings (the modality frontend carve-out in the brief).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig


def seeded(*ints: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of non-negative ints (the port's
    ``fold_in``): distinct tuples give unrelated streams."""
    seed = int(np.random.SeedSequence(list(ints)).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed & (2**63 - 1))


def _gamma(alpha: float, shape, gen: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws in float64 (Marsaglia–Tsang, with the
    ``U**(1/alpha)`` boost for alpha < 1), all from ``gen``."""
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float64)
    todo = torch.ones(shape, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(shape, generator=gen, dtype=torch.float64)
        u = torch.rand(shape, generator=gen, dtype=torch.float64)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp(min=1e-300)))
        take = todo & ok
        out[take] = (d * v)[take]
        todo &= ~ok
    if boost:
        out *= torch.rand(shape, generator=gen, dtype=torch.float64) ** (1.0 / alpha)
    return out


def markov_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int,
                  order_states: int = 64) -> torch.Tensor:
    """(batch, seq) int32 tokens from a random sparse transition table:
    each of ``order_states`` hidden states has a Dirichlet(0.05) row over
    ``min(vocab, 4096)`` tokens, and the state moves to
    ``(state·31 + token) mod order_states``.  One table per ``gen``."""
    v_eff = min(vocab, 4096)                 # transition table over a clamped vocab
    g = _gamma(0.05, (order_states, v_eff), gen)
    table = g / g.sum(dim=1, keepdim=True).clamp(min=1e-300)
    logp = torch.log(table + 1e-9)
    state = torch.randint(0, order_states, (batch,), generator=gen)
    # Gumbel-max: one categorical draw per (step, row) from one block of noise
    u = torch.rand((seq, batch, v_eff), generator=gen, dtype=torch.float64)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-300)))
    toks = torch.empty((seq, batch), dtype=torch.int64)
    for t in range(seq):
        tok = (logp[state] + gumbel[t]).argmax(dim=-1)
        toks[t] = tok
        state = (state * 31 + tok) % order_states
    return toks.T.contiguous().to(torch.int32)


def make_batch(cfg: ModelConfig, gen: torch.Generator, batch: int, seq: int,
               vision_frac: float = 0.25, device=None) -> dict:
    """Training batch for one agent, on ``device`` (the card unless
    ``device="cpu"``).  Returns the dict ``forward`` expects."""
    dev = resolve_device(device)
    put = lambda t: t.to(dev)
    if cfg.arch_type == "vlm":
        s_vis = int(seq * vision_frac)
        s_txt = seq - s_vis
        tokens = markov_tokens(gen, batch, s_txt, cfg.vocab_size)
        vis = (torch.randn((batch, s_vis, cfg.d_model), generator=gen) * 0.02).to(
            getattr(torch, cfg.dtype))
        labels = torch.cat([torch.full((batch, s_vis), -1, dtype=torch.int32), tokens],
                           dim=1)
        return {"tokens": put(tokens), "extra_embeds": put(vis), "labels": put(labels),
                "positions": put(_mrope_positions(batch, s_vis, s_txt))}
    tokens = markov_tokens(gen, batch, seq, cfg.vocab_size)
    return {"tokens": put(tokens), "labels": put(tokens)}


def _mrope_positions(batch: int, s_vis: int, s_txt: int) -> torch.Tensor:
    """Temporal/height/width position streams: a √s_vis×√s_vis image grid
    followed by linear text positions (Qwen2-VL convention, simplified);
    (3, batch, s_vis + s_txt) int32."""
    side = max(1, int(s_vis ** 0.5))
    idx = torch.arange(s_vis)
    h = torch.clamp(idx // side, max=side - 1)
    w = idx % side
    t_txt = side + torch.arange(s_txt)
    pos_t = torch.cat([torch.zeros(s_vis, dtype=torch.int64), t_txt])
    pos_h = torch.cat([h, t_txt])
    pos_w = torch.cat([w, t_txt])
    pos3 = torch.stack([pos_t, pos_h, pos_w]).to(torch.int32)
    return pos3[:, None].expand(3, batch, s_vis + s_txt).contiguous()


def stack_batches(per_agent: list) -> dict:
    """Per-agent batches stacked along a new leading agent axis."""
    return {k: torch.stack([b[k] for b in per_agent]) for k in per_agent[0]}


def agent_batches(cfg: ModelConfig, n_agents: int, batch_per_agent: int,
                  seq: int, round_idx: int, seed: int = 0, device=None) -> dict:
    """Per-agent stacked batch (leading agent axis): agent i of round k draws
    from ``seeded(seed, i, k)``."""
    return stack_batches([make_batch(cfg, seeded(seed, i, round_idx), batch_per_agent,
                                     seq, device=device) for i in range(n_agents)])
