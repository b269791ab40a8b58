"""State-of-the-art baselines the paper compares against (Table 2).

Counterpart of ``repro.core.baselines``.  All four are "space-ified" as
the paper describes: the active set S_k comes from the orbit scheduler
(or Bernoulli sampling), and both links are wrapped in the
algorithm-agnostic EF channel of Fig. 3.

  * FedAvg   (McMahan et al., 2017)  local GD + model averaging
  * FedProx  (Li et al., 2020b)      FedAvg + proximal term μ
  * LED      (Alghunaim, 2024)       local exact diffusion, star-adapted
  * 5GCS     (Grudzień et al., 2023) prox-point local training with
                                     client sampling + control variates

Shared state layout (leading agent axis N where noted):
    x      (N, …)  last local model per agent (used by the e_k metric)
    m_hat  (N, …)  coordinator's last-received uplink wire per agent
    c_up   (N, …)  per-agent uplink EF cache
    c_down (…)     coordinator downlink EF cache
    extra          algorithm-specific: ``()`` for FedAvg, ψ_prev (a tree
                   like x) for LED, the one-tuple ``(h,)`` for 5GCS
    k              rounds done (a Python int, as in ``FedLTState``)

Every round runs all agents at once: the local steps through
``torch.func.vmap(torch.func.grad(loss))`` over agent-stacked trees, the
uplink as one batched ``EFChannel.send``.  The downlink draws from the
round's generator first, then the uplink, as in
:meth:`repro_torch.core.fedlt.FedLT.round`; LED sends its uplink before
its downlink, and draws in that order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..optim.solvers import local_gd
from .error_feedback import EFChannel
from .fedlt import run_rounds
from .pytree import tree_map, tree_mean_axis0, tree_where_mask, tree_zeros_like


class FedState(NamedTuple):
    x: object
    m_hat: object
    c_up: object
    c_down: object
    extra: object
    k: int


def _stacked(tree, n):
    """``tree`` (no agent axis) broadcast to N agents, as a view."""
    return tree_map(lambda a: a[None].expand((n,) + a.shape), tree)


@dataclasses.dataclass(frozen=True)
class _Base:
    loss: Callable
    n_epochs: int = 10
    gamma: float = 0.1
    uplink: EFChannel = EFChannel()
    downlink: EFChannel = EFChannel()

    def _grad(self):
        return torch.func.vmap(torch.func.grad(self.loss))

    def _ef_uplink(self, gen, msgs, caches, active, m_hat_old):
        """One batched uplink EF over agents; inactive agents keep their
        caches and the coordinator their last wires."""
        wire, c_new = self.uplink.send(gen, msgs, caches, batch=True)
        c_up = tree_where_mask(active, c_new, caches)
        m_hat = tree_where_mask(active, wire, m_hat_old)
        return m_hat, c_up

    def _init(self, x0, n_agents: int, extra) -> FedState:
        xN = tree_map(torch.clone, _stacked(x0, n_agents))
        return FedState(x=xN, m_hat=xN, c_up=tree_zeros_like(xN),
                        c_down=tree_zeros_like(x0), extra=extra(xN), k=0)

    def run(self, state: FedState, data, n_rounds: int,
            gen: Optional[torch.Generator] = None, participation: float = 1.0,
            active=None):
        """Drive ``n_rounds`` rounds; returns ``(state, {})``.

        Masks as in :meth:`repro_torch.core.fedlt.FedLT.run`: an explicit
        ``(n_rounds, N)`` bool array, or Bernoulli draws from ``gen`` with
        agent 0 always active below participation 1.0.
        """
        state, _ = run_rounds(self.round, state, data, n_rounds, gen,
                              participation, active)
        return state, {}


@dataclasses.dataclass(frozen=True)
class FedAvg(_Base):
    """Uplink message = local model; the coordinator averages the
    received models.  ``prox_mu > 0`` makes it FedProx."""

    prox_mu: float = 0.0

    def init(self, x0, n_agents: int) -> FedState:
        return self._init(x0, n_agents, lambda xN: ())

    def round(self, state: FedState, data, active,
              gen: Optional[torch.Generator] = None) -> Tuple[FedState, dict]:
        # coordinator: average last-received models, downlink with EF
        y = tree_mean_axis0(state.m_hat)
        y_wire, c_down = self.downlink.send(gen, y, state.c_down)

        # every agent starts its local GD from y_wire (x_i is not read)
        start = _stacked(y_wire, active.shape[0])
        x_new = local_gd(self._grad(), start, data, n_epochs=self.n_epochs,
                         gamma=self.gamma, prox_center=start,
                         prox_mu=self.prox_mu)
        x = tree_where_mask(active, x_new, state.x)
        m_hat, c_up = self._ef_uplink(gen, x, state.c_up, active, state.m_hat)
        return FedState(x, m_hat, c_up, c_down, (), state.k + 1), {}


def FedProx(loss, *, n_epochs=10, gamma=0.1, prox_mu=0.1,
            uplink=EFChannel(), downlink=EFChannel()) -> FedAvg:
    return FedAvg(loss=loss, n_epochs=n_epochs, gamma=gamma, prox_mu=prox_mu,
                  uplink=uplink, downlink=downlink)


@dataclasses.dataclass(frozen=True)
class LED(_Base):
    """Local Exact-Diffusion (Alghunaim, 2024), star-topology adaptation.

    Exact diffusion in adapt–correct–combine form, with the star graph
    realized as lazy full averaging  W̄ = (I + 11ᵀ/N)/2  (the coordinator
    broadcasts the mean, each agent mixes it with its own φ_i):

        ψ_i⁺ = LocalGD(x_i, N_e, γ)                    (adapt, local steps)
        φ_i⁺ = ψ_i⁺ + x_i − ψ_i                        (correction)
        x_i⁺ = (φ_i⁺ + mean_j φ_j⁺)/2                  (combine)

    Initialization ψ_i⁰ = x_i⁰ carries the implicit dual.  Uplink
    message = φ_i.  ``extra`` holds ψ_prev as a bare tree.
    """

    def init(self, x0, n_agents: int) -> FedState:
        return self._init(x0, n_agents, lambda xN: xN)

    def round(self, state: FedState, data, active,
              gen: Optional[torch.Generator] = None) -> Tuple[FedState, dict]:
        psi_prev = state.extra
        # adapt + correct (active agents)
        psi_new = local_gd(self._grad(), state.x, data, n_epochs=self.n_epochs,
                           gamma=self.gamma)
        phi = tree_map(lambda p, xl, pp: p + xl - pp, psi_new, state.x, psi_prev)
        psi = tree_where_mask(active, psi_new, psi_prev)

        # uplink φ_i, coordinator aggregates THIS round's wires, downlink
        # (so here the uplink draws from ``gen`` first)
        m_hat, c_up = self._ef_uplink(gen, phi, state.c_up, active, state.m_hat)
        y = tree_mean_axis0(m_hat)
        y_wire, c_down = self.downlink.send(gen, y, state.c_down)

        # combine (lazy star mixing), active agents only
        x_new = tree_map(lambda ph, yb: 0.5 * (ph + yb[None]), phi, y_wire)
        x = tree_where_mask(active, x_new, state.x)
        return FedState(x, m_hat, c_up, c_down, psi, state.k + 1), {}


@dataclasses.dataclass(frozen=True)
class FiveGCS(_Base):
    """5GCS (Grudzień, Malinovsky, Richtárik 2023), simplified.

    Sampled clients approximately solve the prox subproblem
        w_i ≈ argmin_w f_i(w) + ‖w − (y + γ_p·h_i)‖²/(2·γ_p)
    with N_e local GD steps; control variates h_i ← h_i + (w̄_S − w_i)/γ_p;
    the server moves toward the average of the received prox points.
    ``extra`` holds ``(h,)``.
    """

    gamma_p: float = 1.0     # prox radius γ_p
    server_lr: float = 1.0   # η: y ← y + η·mean_active(ŵ_i − y)

    def init(self, x0, n_agents: int) -> FedState:
        return self._init(x0, n_agents, lambda xN: (tree_zeros_like(xN),))

    def round(self, state: FedState, data, active,
              gen: Optional[torch.Generator] = None) -> Tuple[FedState, dict]:
        y = tree_mean_axis0(state.m_hat)
        y_wire, c_down = self.downlink.send(gen, y, state.c_down)

        grad_fn = self._grad()
        (h,) = state.extra
        inv_gp = 1.0 / self.gamma_p
        center = tree_map(lambda yb, hh: yb[None] + self.gamma_p * hh, y_wire, h)

        def prox_grad(w, d):
            g = grad_fn(w, d)
            return tree_map(lambda gl, wl, cl: gl + inv_gp * (wl - cl),
                            g, w, center)

        w_new = local_gd(prox_grad, _stacked(y_wire, active.shape[0]), data,
                         n_epochs=self.n_epochs, gamma=self.gamma)
        x = tree_where_mask(active, w_new, state.x)

        # Σ h_i-conserving control-variate update: the anchor is the mean of
        # the prox points over the active set:  h_i ← h_i + (w̄_S − w_i)/γ_p
        n_act = torch.clamp(torch.sum(active), min=1)

        def masked_mean(leaf):
            m = active.reshape((-1,) + (1,) * (leaf.ndim - 1))
            return torch.sum(torch.where(m, leaf, 0), dim=0) / n_act

        w_bar = tree_map(masked_mean, w_new)
        h_new = tree_map(lambda hh, wb, wl: hh + inv_gp * (wb[None] - wl),
                         h, w_bar, w_new)
        h = tree_where_mask(active, h_new, h)

        # server target y + η·(w − y), sent as the uplink message so the
        # coordinator can aggregate wires directly
        msg = tree_map(lambda yb, wl: yb[None] + self.server_lr * (wl - yb[None]),
                       y_wire, w_new)
        m_hat, c_up = self._ef_uplink(gen, msg, state.c_up, active, state.m_hat)
        return FedState(x, m_hat, c_up, c_down, (h,), state.k + 1), {}

