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
        x, z, c_up, z_hat = self._agents(y_wire, state.x, state.z, state.c_up,
                                         state.z_hat, data, active, gen)
        new_state = FedLTState(x=x, z=z, c_up=c_up, z_hat=z_hat,
                               c_down=c_down_new, k=state.k + 1)
        return new_state, {"n_active": torch.sum(active)}

    def _agents(self, y_wire, x, z, c_up, z_hat, data, active, gen):
        """The agents' half of a round for the agents the trees hold: local
        training, partial participation and the uplink; returns
        (x, z, c_up, z_hat) after the round."""
        # ---- agents: local training (paper lines 8-14), all at once ----
        grad_fn = torch.func.vmap(torch.func.grad(self.loss))
        v = tree_map(lambda y, zz: 2.0 * y - zz, y_wire, z)
        x_new = local_prox_gd(grad_fn, x, v, data, n_epochs=self.n_epochs,
                              gamma=self.gamma, rho=self.rho)
        z_new = tree_map(lambda zz, xn, y: zz + 2.0 * (xn - y), z, x_new, y_wire)

        # partial participation: inactive agents keep x, z (paper line 18)
        x_next = tree_where_mask(active, x_new, x)
        z_next = tree_where_mask(active, z_new, z)

        # ---- uplink EF + transmit (paper lines 15-16), per agent ----
        if self.fused_uplink and self.uplink.fusable():
            wire, c_up_new = self.uplink.send_fused(z_next, c_up)
        else:
            wire, c_up_new = self.uplink.send(gen, z_next, c_up, batch=True)
        return (x_next, z_next, tree_where_mask(active, c_up_new, c_up),
                tree_where_mask(active, wire, z_hat))

    # -- fleet-sharded round (mega-constellation scaling) ------------------
    def round_sharded(self, mesh, n_agents: int) -> Callable:
        """A round function whose agent axis is sharded over ``mesh``'s
        first axis (the "fleet" axis): one rank per shard.

        Each rank trains its shard of the fleet; the only cross-rank
        traffic is the coordinator aggregate (each rank's z_hat mean
        weighted by its share of the agents, ``n_local / n_agents``, the
        local sum over ``n_agents``, then one ``all_reduce`` per leaf) and
        the count of active agents (one more ``all_reduce``); the downlink
        is computed on every rank alike.  On one rank the aggregate is
        ``tree_mean_axis0`` bit for bit, so the round is :meth:`round`'s.
        Same signature and semantics as :meth:`round` (up to float
        summation order in the aggregate): it takes the state as
        :func:`repro_torch.launch.sharding.shard_fleet` lays it out, or as
        full tensors, of which each rank reads its shard, and returns
        DTensors, the agent-stacked leaves ``Shard(0)`` and ``c_down``
        ``Replicate()``.  ``data`` and ``active`` may be either too.  A
        stochastic compressor draws from each rank's own ``gen``.
        ``n_agents`` must divide by the fleet axis size;
        :func:`repro_torch.launch.sharding.fleet_mesh` returns ``None`` on
        a single device (use :meth:`round` then).
        """
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate, Shard

        n_dev = mesh.size(0)
        if n_agents % n_dev:
            raise ValueError(
                f"n_agents={n_agents} not divisible by fleet axis {n_dev}")
        group = mesh.get_group(0)
        n_local = n_agents // n_dev
        lo = mesh.get_local_rank(0) * n_local

        def local(t):
            if isinstance(t, DTensor):
                return t.to_local()
            return t[lo:lo + n_local]

        def whole(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def aggregate(s):
            y = torch.mean(s, dim=0)
            if n_local != n_agents:
                y = y * (n_local / n_agents)
            dist.all_reduce(y, group=group)
            return y

        def shard(t):
            return DTensor.from_local(t, mesh, [Shard(0)], run_check=False)

        def rep(t):
            return DTensor.from_local(t, mesh, [Replicate()], run_check=False)

        def round_fn(state: FedLTState, data, active, gen=None):
            x, z, c_up, z_hat = (tree_map(local, t) for t in state[:4])
            act = local(active if isinstance(active, DTensor)
                        else torch.as_tensor(active))
            # coordinator aggregate: local shard mean by its share + all_reduce
            y_mean = tree_map(aggregate, z_hat)
            y_wire, c_down_new = self.downlink.send(
                gen, y_mean, tree_map(whole, state.c_down))
            x, z, c_up, z_hat = self._agents(y_wire, x, z, c_up, z_hat,
                                             tree_map(local, data), act, gen)
            n_active = torch.sum(act)
            dist.all_reduce(n_active, group=group)
            new_state = FedLTState(
                x=tree_map(shard, x), z=tree_map(shard, z),
                c_up=tree_map(shard, c_up), z_hat=tree_map(shard, z_hat),
                c_down=tree_map(rep, c_down_new), k=state.k + 1)
            return new_state, {"n_active": n_active}

        return round_fn

    def run(self, state: FedLTState, data, n_rounds: int,
            gen: Optional[torch.Generator] = None, participation: float = 1.0,
            active=None, mesh=None):
        """Drive ``n_rounds`` rounds; returns (state, {"n_active": (n_rounds,)}).

        ``active``: an explicit ``(n_rounds, N)`` bool array of per-round
        participation masks.  Without it, every agent is active at
        participation 1.0; below 1.0 masks are Bernoulli draws from ``gen``
        with agent 0 always active (the paper assumes p_i > 0); every rank
        must then draw the same masks, from generators seeded alike.
        ``mesh``: optional fleet mesh (see :meth:`round_sharded`): the
        agent axis shards across its ranks; ``None`` runs :meth:`round`.
        """
        n_agents = tree_leaves(state.x)[0].shape[0]
        round_impl = (self.round if mesh is None
                      else self.round_sharded(mesh, n_agents))
        state, infos = run_rounds(round_impl, state, data, n_rounds, gen,
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
