"""The paper's experimental problem (§3, eq. (2)).

Regularized logistic regression over N agents:

    f_i(x) = (1/m_i) Σ_h log(1 + exp(−b_{i,h} · a_{i,h}ᵀ x)) + ε/(2N)·‖x‖²

with ε = 50, m_i = 500, n = 100, N = 100, randomly generated data.  Also a
Newton solver for the global optimum x̄ of Σ_i f_i, the reference point
of the optimality error e_k = Σ_i ‖x_{i,k} − x̄‖².
"""
from __future__ import annotations

import torch

from ..device import resolve_device


def generate(seed: int = 0, *, n_agents: int = 100, m: int = 500,
             dim: int = 100, label_noise: float = 0.05,
             feature_scale: float = 1.0, device=None):
    """Random data: features ~ N(0, scale²·I), labels from a planted model.

    Drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``;
    the numbers are not those of the JAX package's ``generate``.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    a = feature_scale * torch.randn((n_agents, m, dim), generator=g, device=dev)
    w_true = torch.randn((dim,), generator=g, device=dev)
    logits = torch.einsum("imd,d->im", a, w_true)
    b = torch.sign(logits + 1e-12)
    flip = torch.rand(b.shape, generator=g, device=dev) < label_noise
    b = torch.where(flip, -b, b)
    return {"a": a, "b": b}, w_true


def make_local_loss(eps: float = 50.0, n_agents: int = 100):
    """Returns loss(params, data_i) for one agent (data_i: a (m,d), b (m,))."""

    def loss(x, data_i):
        margins = data_i["b"] * (data_i["a"] @ x)
        return (torch.mean(torch.log1p(torch.exp(-margins)))
                + eps / (2.0 * n_agents) * torch.sum(x * x))

    return loss


def solve_global(data, eps: float = 50.0, iters: int = 50) -> torch.Tensor:
    """Newton's method on F(x) = Σ_i f_i(x); returns x̄.

    Σ_i f_i(x) = Σ_i mean_h ℓ(x; a, b) + (ε/2)‖x‖², smooth and strongly
    convex.  The solve is ``torch.linalg.solve``, outside any kernel of
    the port, as the JAX package left it to XLA.
    """
    a = data["a"].reshape(-1, data["a"].shape[-1])   # (N·m, d)
    b = data["b"].reshape(-1)
    m = data["a"].shape[1]
    d = a.shape[-1]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    x = torch.zeros((d,), dtype=a.dtype, device=a.device)
    for _ in range(iters):
        margins = b * (a @ x)
        s = torch.sigmoid(-margins)              # ℓ'(t) = −σ(−t), t = b aᵀx
        # gradient of Σ_i mean_h: each agent means over its own m ⇒ 1/m per row
        g = -(a.T @ (b * s)) / m + eps * x
        w = s * (1.0 - s) / m                     # ℓ'' weights
        H = (a.T * w) @ a + eps * eye
        x = x - torch.linalg.solve(H, g)
    return x
