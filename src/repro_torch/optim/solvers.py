"""Local solvers.

The Fed-LT local subproblem (paper Alg. 1/2 line 10) is

    w^{ℓ+1} = w^ℓ − γ (∇f_i(w^ℓ) + (w^ℓ − v)/ρ),

gradient descent on f_i(w) + ‖w − v‖²/(2ρ), run for N_e epochs in a Python
loop.  ``local_gd`` is the plain (FedAvg-style) variant.  Both work on
trees of any shape: for all agents at once, pass agent-stacked trees and
a batched gradient (``torch.func.vmap(torch.func.grad(loss))``).  SGD and
Adam are for the standalone (non-federated) training drivers, as in the
JAX package; they return new trees and leave their inputs as they were.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.pytree import tree_map


def local_prox_gd(grad_fn: Callable, w0, v, data, *, n_epochs: int,
                  gamma: float, rho: float):
    """N_e epochs of prox-anchored GD. grad_fn(w, data) -> grad tree."""
    inv_rho = 1.0 / rho
    w = w0
    for _ in range(n_epochs):
        g = grad_fn(w, data)
        w = tree_map(lambda wl, gl, vl: wl - gamma * (gl + inv_rho * (wl - vl)),
                     w, g, v)
    return w


def local_gd(grad_fn: Callable, w0, data, *, n_epochs: int, gamma: float,
             prox_center=None, prox_mu: float = 0.0):
    """Plain local GD; optional FedProx term  μ/2·‖w − prox_center‖²."""
    w = w0
    for _ in range(n_epochs):
        g = grad_fn(w, data)
        if prox_center is not None and prox_mu > 0.0:
            w = tree_map(lambda wl, gl, cl: wl - gamma * (gl + prox_mu * (wl - cl)),
                         w, g, prox_center)
        else:
            w = tree_map(lambda wl, gl: wl - gamma * gl, w, g)
    return w


# ---------------------------------------------------------------------------
# Optimizers for the standalone training drivers.
# ---------------------------------------------------------------------------

def sgd(params, grads, lr: float, momentum_state=None, momentum: float = 0.0):
    """One SGD step, with heavy-ball momentum when given a state and a
    nonzero ``momentum``: (new params, new momentum state)."""
    if momentum_state is None or momentum == 0.0:
        return tree_map(lambda p, g: p - lr * g, params, grads), momentum_state
    new_m = tree_map(lambda m, g: momentum * m + g, momentum_state, grads)
    return tree_map(lambda p, m: p - lr * m, params, new_m), new_m


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: int       # steps taken (JAX keeps an int32 scalar)


def adam_init(params) -> AdamState:
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params), count=0)


def adam_update(params, grads, state: AdamState, *, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0):
    """One Adam step (bias-corrected; decoupled ``weight_decay`` as in the
    JAX package): (new params, new state).  The bias corrections are
    float32, as JAX computes them from its int32 count."""
    count = state.count + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    c = np.float32(count)
    one = np.float32(1.0)
    mhat_scale = float(one / (one - np.float32(b1) ** c))
    vhat_scale = float(one / (one - np.float32(b2) ** c))

    def upd(p, m, v):
        step = lr * (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p
        return p - step

    return tree_map(upd, params, mu, nu), AdamState(mu, nu, count)
