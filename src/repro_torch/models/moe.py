"""Mixture-of-Experts MLP (top-k router) — grok-1, mixtral.

Counterpart of ``repro.models.moe``.  Two dispatch modes
(``cfg.moe_dispatch``):

  * ``dense``    — every token is run through EVERY expert and combined with
                   top-k gate weights (zeros elsewhere).
  * ``capacity`` — GSPMD/Switch-style: within a group of ``MOE_GROUP``
                   tokens each expert processes at most
                   C = ceil(G·k·cf/E) tokens, selected by one-hot dispatch
                   einsums.  Routes past an expert's capacity are dropped.

Router: softmax over expert logits, top-k, weights renormalized among the
selected experts (mixtral convention).  An auxiliary load-balance loss
(Switch §2.2) is returned for the training objective.

The JAX package computes all of this in XLA, outside any Pallas kernel, so
the port's einsums and matrix products are PyTorch's.  Three places keep
the reference's semantics by hand: top-k breaks ties toward the lower
expert index (``jax.lax.top_k``; ``torch.topk`` does not), a route past
capacity encodes as an all-zero one-hot row (``jax.nn.one_hot``), and no
gradient flows through the dispatch one-hot or ``gates > 0``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import act_fn, init_normal


def init_moe(cfg, dtype, *, generator=None, device=None, lead=()):
    """router (d, E), up/gate (E, d, f) ~ N(0, 1)/√d and down (E, f, d) ~
    N(0, 1)/√f in ``dtype``, as ``repro.models.moe.init_moe``; ``lead``
    prefixes every shape (the repeats of a stacked slot)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(generator=generator, device=device)
    lead = tuple(lead)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {"router": init_normal(lead + (d, e), s_in, dtype, **kw),
            "up": init_normal(lead + (e, d, f), s_in, dtype, **kw),
            "gate": init_normal(lead + (e, d, f), s_in, dtype, **kw),
            "down": init_normal(lead + (e, f, d), s_out, dtype, **kw)}


def _route(params, x, cfg):
    """x: (T, D) → gate weights (T, E) (zeros off top-k), probs, top-k idx.

    A stable descending sort cut to k is ``jax.lax.top_k``: of equal
    probabilities the lower expert index comes first.  A zero row (the
    capacity dispatch's padding) has exactly uniform probabilities, so
    this decides which experts its routes take."""
    logits = (x @ params["router"]).to(torch.float32)        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :cfg.moe_top_k], top_i[:, :cfg.moe_top_k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, top_i, top_w)
    return gates, probs, top_i


def _expert_mlp(params, x, cfg):
    """x: (E, C, D) → (E, C, D), batched over experts."""
    h = torch.einsum("ecd,edf->ecf", x, params["up"])
    g = torch.einsum("ecd,edf->ecf", x, params["gate"])
    h = act_fn(cfg.mlp_act)(g) * h
    return torch.einsum("ecf,efd->ecd", h, params["down"])


def load_balance_loss(probs, gates, n_experts: int):
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e (no gradient through
    the token fractions f_e)."""
    frac_tokens = (gates > 0).to(torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return n_experts * (frac_tokens * frac_probs).sum()


def moe_dense(params, x, cfg):
    """x: (B, S, D).  All experts on all tokens, gate-combined."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, probs, _ = _route(params, xt, cfg)
    # (E, T, D): every expert sees every token
    h = torch.einsum("td,edf->etf", xt, params["up"])
    g = torch.einsum("td,edf->etf", xt, params["gate"])
    h = act_fn(cfg.mlp_act)(g) * h
    out = torch.einsum("etf,efd->etd", h, params["down"])
    out = torch.einsum("etd,te->td", out, gates.to(out.dtype))
    aux = load_balance_loss(probs, gates, cfg.n_experts)
    return out.reshape(b, s, d), aux


# tokens per dispatch group: bounds the (G, E, C) one-hot tensors — their
# size per token is E·C = E·(G·k·cf/E) = G·k·cf, so SMALLER groups mean
# proportionally smaller dispatch/combine tensors.  256 ⇒ 640 slots/token
# at k=2.
MOE_GROUP = 256


def moe_capacity(params, x, cfg):
    """GSPMD/Switch-style capacity dispatch with token groups.

    Tokens are padded with zero rows to a multiple of G = min(MOE_GROUP, T)
    and partitioned into groups of G; within each group every expert
    accepts at most C = ceil(G·k·cf/E) tokens, slot 0's routes first, then
    slot 1's (overflow dropped, standard).  The dispatch/combine one-hots
    are (n_g, G, E, C).  The pad rows route, take capacity and count in
    the aux loss's means, as in the JAX package.

    The JAX package's ``wsc`` (``with_sharding_constraint`` on
    ``cfg.act_batch_axis``) is numerically neutral; the port has no mesh
    until its launch/ slice, so here it is a no-op and is left out.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k

    xt = x.reshape(-1, d)
    t = xt.shape[0]
    g = min(MOE_GROUP, t)
    pad = (-t) % g
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    n_g = xt.shape[0] // g
    cap = max(1, math.ceil(g * k * cfg.capacity_factor / e))
    cap = min(cap, g)

    gates, probs, top_i = _route(params, xt, cfg)            # (T', E), (T', k)
    gates_g = gates.reshape(n_g, g, e)
    top_g = top_i.reshape(n_g, g, k)
    slots = torch.arange(cap, device=x.device, dtype=torch.float32)

    combine = torch.zeros((n_g, g, e, cap), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((n_g, g, e, cap), dtype=torch.bool, device=x.device)
    used = torch.zeros((n_g, e), dtype=torch.float32, device=x.device)
    for c in range(k):
        onehot = F.one_hot(top_g[..., c], e).to(torch.float32)        # (n_g,G,E)
        pos = torch.cumsum(onehot, dim=1) - 1.0 + used[:, None, :]
        pos_tok = (pos * onehot).sum(dim=-1)                           # (n_g, G)
        keep = pos_tok < cap
        w = (gates_g * onehot).sum(dim=-1) * keep
        # jax.nn.one_hot: a position past capacity (a dropped route) is a
        # zero row (F.one_hot would raise on it)
        pos_oh = (pos_tok[..., None] == slots).to(torch.float32)       # (n_g,G,C)
        sel = onehot[..., None] * pos_oh[..., None, :]                 # (n_g,G,E,C)
        combine = combine + w[..., None, None] * sel
        dispatch = dispatch | ((sel > 0) & keep[..., None, None])
        used = used + (onehot * keep[..., None]).sum(dim=1)

    # dispatch: (n_g, E, C, D) → experts run on (E, n_g·C, D).  The one-hot
    # is built from routing decisions only: no gradient flows through it.
    xg = xt.reshape(n_g, g, d)
    disp_f = dispatch.to(xt.dtype)
    xe = torch.einsum("gtec,gtd->gecd", disp_f, xg)
    xe = xe.permute(1, 0, 2, 3).reshape(e, n_g * cap, d)
    ye = _expert_mlp(params, xe, cfg)
    ye = ye.reshape(e, n_g, cap, d).permute(1, 0, 2, 3)
    out = torch.einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)
    out = out.reshape(-1, d)[:t]
    aux = load_balance_loss(probs, gates, e)
    return out.reshape(b, s, d), aux


def moe(params, x, cfg):
    if cfg.moe_dispatch == "capacity":
        return moe_capacity(params, x, cfg)
    return moe_dense(params, x, cfg)
