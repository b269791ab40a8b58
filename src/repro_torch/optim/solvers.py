"""Local solvers.

The Fed-LT local subproblem (paper Alg. 1/2 line 10) is

    w^{ℓ+1} = w^ℓ − γ (∇f_i(w^ℓ) + (w^ℓ − v)/ρ),

gradient descent on f_i(w) + ‖w − v‖²/(2ρ), run for N_e epochs in a Python
loop.  ``local_gd`` is the plain (FedAvg-style) variant.  Both work on
trees of any shape: for all agents at once, pass agent-stacked trees and
a batched gradient (``torch.func.vmap(torch.func.grad(loss))``).
"""
from __future__ import annotations

from typing import Callable

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
