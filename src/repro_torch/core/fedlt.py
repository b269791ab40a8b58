"""Fed-LT with bi-directional compression and error feedback.

Algorithms 1 and 2 of the paper for all N agents at once, each per-agent
quantity carrying a leading agent axis.  Algorithm 1 (compression, no EF)
and Algorithm 2 (compression + EF) are one code path: pass
``EFChannel(C, enabled=False)`` for Algorithm 1, as in the paper's Table 1.

State layout (leaves carry a leading agent axis N where noted):

    x      (N, …)  per-agent models x_i
    z      (N, …)  per-agent auxiliaries z_i
    c_up   (N, …)  per-agent uplink EF caches c_i
    z_hat  (N, …)  coordinator's last-received uplink wire per agent
    c_down (…)     coordinator downlink EF cache c
    k              rounds done (a Python int)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..optim.solvers import local_prox_gd
from .error_feedback import EFChannel
from .pytree import (tree_leaves, tree_map, tree_mean_axis0, tree_where_mask,
                     tree_zeros_like)


class FedLTState(NamedTuple):
    x: object
    z: object
    c_up: object
    z_hat: object
    c_down: object
    k: int


@dataclasses.dataclass(frozen=True)
class FedLT:
    """Algorithm 2 (paper). loss(params, agent_data) -> scalar.

    ``n_epochs`` = N_e, ``gamma`` = local step γ, ``rho`` = ρ.
    """

    loss: Callable
    n_epochs: int = 10
    gamma: float = 0.1
    rho: float = 1.0
    uplink: EFChannel = EFChannel()
    downlink: EFChannel = EFChannel()
    # one fused compress→EF→pack kernel over the whole agent-stacked uplink
    # instead of the batched add→compress→subtract chain (requires
    # uplink.fusable(): clip=True uniform quantizer with EF on; takes the
    # batched chain otherwise)
    fused_uplink: bool = False

    # -- setup ------------------------------------------------------------
    def init(self, x0, n_agents: int) -> FedLTState:
        """x0: single-model tree (no agent axis); replicated to all agents."""
        xN = tree_map(lambda a: a[None].expand((n_agents,) + a.shape).clone(), x0)
        return FedLTState(x=xN, z=xN, c_up=tree_zeros_like(xN), z_hat=xN,
                          c_down=tree_zeros_like(x0), k=0)

    # -- one communication round ------------------------------------------
    def round(self, state: FedLTState, data, active,
              gen: Optional[torch.Generator] = None) -> Tuple[FedLTState, dict]:
        """One iteration of the outer loop.

        data:   tree with leading agent axis N on every leaf.
        active: bool (N,) tensor, the set S_{k+1}.
        gen:    generator for stochastic compressors (unused otherwise);
                the downlink draws from it first, then the uplink.
        """
        # ---- coordinator: aggregate + downlink EF (paper lines 3-5) ----
        y_mean = tree_mean_axis0(state.z_hat)
        y_wire, c_down_new = self.downlink.send(gen, y_mean, state.c_down)

        # ---- agents: local training (paper lines 8-14), all at once ----
        grad_fn = torch.func.vmap(torch.func.grad(self.loss))
        v = tree_map(lambda y, z: 2.0 * y - z, y_wire, state.z)
        x_new = local_prox_gd(grad_fn, state.x, v, data, n_epochs=self.n_epochs,
                              gamma=self.gamma, rho=self.rho)
        z_new = tree_map(lambda z, xn, y: z + 2.0 * (xn - y), state.z, x_new,
                         y_wire)

        # partial participation: inactive agents keep x, z (paper line 18)
        x_next = tree_where_mask(active, x_new, state.x)
        z_next = tree_where_mask(active, z_new, state.z)

        # ---- uplink EF + transmit (paper lines 15-16), per agent ----
        if self.fused_uplink and self.uplink.fusable():
            wire, c_up_new = self.uplink.send_fused(z_next, state.c_up)
        else:
            wire, c_up_new = self.uplink.send(gen, z_next, state.c_up, batch=True)
        c_up_next = tree_where_mask(active, c_up_new, state.c_up)
        z_hat_next = tree_where_mask(active, wire, state.z_hat)

        new_state = FedLTState(x=x_next, z=z_next, c_up=c_up_next,
                               z_hat=z_hat_next, c_down=c_down_new,
                               k=state.k + 1)
        return new_state, {"n_active": torch.sum(active)}

    def run(self, state: FedLTState, data, n_rounds: int,
            gen: Optional[torch.Generator] = None, participation: float = 1.0,
            active=None):
        """Drive ``n_rounds`` rounds; returns (state, {"n_active": (n_rounds,)}).

        ``active``: an explicit ``(n_rounds, N)`` bool array of per-round
        participation masks.  Without it, every agent is active at
        participation 1.0; below 1.0 masks are Bernoulli draws from ``gen``
        with agent 0 always active (the paper assumes p_i > 0).
        """
        state, infos = run_rounds(self.round, state, data, n_rounds, gen,
                                  participation, active)
        return state, {"n_active": torch.stack([i["n_active"] for i in infos])}


def run_rounds(round_fn, state, data, n_rounds: int,
               gen: Optional[torch.Generator], participation: float, active):
    """``n_rounds`` calls of ``round_fn(state, data, mask, gen)`` under
    the per-round masks :meth:`FedLT.run` describes; returns the final
    state and the rounds' info dicts."""
    x_leaf = tree_leaves(state.x)[0]
    n_agents, dev = x_leaf.shape[0], x_leaf.device
    if active is None:
        if participation < 1.0:
            if gen is None:
                raise ValueError("partial participation draws its masks "
                                 "from a torch.Generator; pass gen")
            active = torch.rand((n_rounds, n_agents), generator=gen,
                                device=dev) < participation
            active[:, 0] = True
        else:
            active = torch.ones((n_rounds, n_agents), dtype=torch.bool,
                                device=dev)
    else:
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
        if tuple(active.shape) != (n_rounds, n_agents):
            raise ValueError(f"active masks have shape {tuple(active.shape)}, "
                             f"expected ({n_rounds}, {n_agents})")
    infos = []
    for r in range(n_rounds):
        state, info = round_fn(state, data, active[r], gen)
        infos.append(info)
    return state, infos


def optimality_error(x_agents, x_star):
    """Paper §3 metric: e_k = Σ_i ‖x_{i,k} − x̄‖²."""
    diffs = tree_map(lambda xa, xs: xa - xs[None], x_agents, x_star)
    return sum(torch.sum(d * d) for d in tree_leaves(diffs))
