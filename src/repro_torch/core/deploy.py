"""Deploy mode: one federated round of Fed-LT on a transformer's parameters.

Counterpart of ``repro.core.deploy``, the path that ``launch/train.py``
drives.  Every per-agent state leaf carries a leading agent axis A; the
JAX package ``vmap``s local training over it inside one mesh-sharded
step, the port runs the agents one after another.  The paper's
Algorithm 2 runs inside the round:

  1. v = 2·ŷ − z;  N_e prox-gradient epochs on the LM loss   (local training)
  2. z ← z + 2(x − ŷ)
  3. uplink: wire = Q(z + c_up) as integer level indices     (uplink EF);
     with ``pack_wire=True`` the indices of each leaf of at least one
     kernel tile (32768 values) are bit-packed into b-bit uint32 wire
     words, by one ``quant_pipeline`` launch (``fuse_pipeline=True``) or
     by the quantizer and one ``pack_bits`` launch, and unpacked with
     ``unpack_bits`` on the coordinator side
  4. ȳ = mean_A decode(wire);  y = c_down + ȳ
  5. ŷ = decode(Q(y));  c_down = y − ŷ                      (downlink EF)

Each epoch takes ``torch.autograd.grad`` of ``lm_loss`` on one agent's
slice; with the ``chunked`` backend attention runs the hand-written
forward kernels and ``flash_attention_bwd``.  The round's stages run
under ``torch.profiler.record_function`` spans with the JAX package's
``jax.named_scope`` names (``fedlt.local_train``, ``fedlt.uplink``,
``fedlt.uplink.fused_pipeline``, ``fedlt.aggregate``, ``fedlt.downlink``).

Quantization arithmetic: the corrected message z + c_up and the downlink's
y are quantized in float32 whatever the leaf's dtype, as the fused kernel
(and the JAX kernel) computes, and stored back in the leaf's dtype.  So
the fused and unfused routes give equal words, caches and means bit for
bit, for bf16 leaves too.  For float32 leaves this is the JAX package's
arithmetic.  On bf16 leaves the JAX package's unfused uplink and its
downlink run the quantizer in bf16 ops, a few levels off the nearest
one; ``tests/test_torch_deploy.py::test_bf16_round_split_from_jax``
bounds the split (ROADMAP Queue 3).

Partial participation is a host-side decision (the orbit scheduler picks
which satellites run a round); ``survivors`` is the quorum mask of a
round closed at its deadline.  The round is functional: it returns a new
state and leaves the one it was given as it was.

Sharded (``agent_replicate_spec``, the dry-run's and a multi-rank
launch's round): the state is DTensors laid out by
``launch.sharding.param_specs``, the agent dim over the agent mesh axes.
Each rank trains its own agents (weights sharded over the other axes run
as DTensors on the sub-mesh of those axes), quantizes its shard, and the
**integer** wire crosses ranks: the uplink gathers the packed words
(``pack_wire``) or the level ints over the agent axes' groups before the
mean, where the JAX package's ``with_sharding_constraint`` replicates the
agent dim.  The aggregate then sums the same integers in the same order
on every rank, so the round's states equal the unsharded round's bit for
bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..device import DTensor, is_dtensor
from ..kernels import ops
from ..kernels.pack_bits import _TILE_VALS
from ..models.transformer import init_params, lm_loss
from .compression import (PIECE, _int_dtype, quantize_decode, quantize_encode,
                          wire_index_bits)
from .pytree import tree_leaves, tree_map, tree_unflatten


def _quantize_ef(z, c, q):
    """Level ints of z + c, formed in float32, and the new EF cache in z's
    dtype; with ``c`` None, the level ints of z alone.  A piece of
    ``PIECE`` values at a time, so the float32 copies of an agent-stacked
    leaf never exist whole (gemma3-27b's embedding table with two agents
    is 2.8e9 values, 11 GB a float32 copy)."""
    zf = z.reshape(-1)
    w = torch.empty(zf.shape, dtype=_int_dtype(q["levels"]), device=z.device)
    newc = None if c is None else torch.empty(zf.shape, dtype=z.dtype, device=z.device)
    cf = None if c is None else c.reshape(-1)
    for s in range(0, zf.numel(), PIECE):
        m = zf[s:s + PIECE].to(torch.float32)
        if c is not None:
            m = m + cf[s:s + PIECE]            # a new tensor: z is never written
        w[s:s + PIECE] = quantize_encode(m, **q)
        if c is not None:
            m -= quantize_decode(w[s:s + PIECE], **q)
            newc[s:s + PIECE] = m
    return w.view(z.shape), None if c is None else newc.view(z.shape)


def _revert_caches(nc, z, c, agents) -> None:
    """The quorum revert: the uplink EF cache of each agent in ``agents``
    (indices into dim 0) becomes its corrected message z + c, in place in
    ``nc`` and in its dtype, a piece of ``PIECE`` values at a time, so no
    whole-leaf temporary is made."""
    for i in agents:
        dst, zf, cf = nc[i].view(-1), z[i].reshape(-1), c[i].reshape(-1)
        for s in range(0, dst.numel(), PIECE):
            dst[s:s + PIECE] = zf[s:s + PIECE] + cf[s:s + PIECE]


def emit_round_series(step: int, metrics: dict) -> None:
    """Fold one ``round_step`` metrics dict into the active trace as
    per-round series samples (no-op when tracing is off); the loss is read
    back from the device only when a tracer is installed."""
    from ..obs.trace import active as _obs_active
    trc = _obs_active()
    if trc is None:
        return
    trc.series("loss", step, float(metrics["loss"]))
    nb = metrics.get("wire_nbytes_per_agent")
    if nb is not None:
        trc.series("wire_nbytes_per_agent", step, float(nb))
    qf = metrics.get("quorum_frac")
    if qf is not None:
        trc.series("quorum_frac", step, float(qf))


class DeployState(NamedTuple):
    x: object        # (A, …) per-agent models
    z: object        # (A, …) auxiliaries
    c_up: object     # (A, …) uplink EF caches
    y_hat: object    # (…)    last broadcast ŷ (the coordinator's output)
    c_down: object   # (…)    downlink EF cache
    k: int


@dataclasses.dataclass(frozen=True)
class DeployFedLT:
    """Fed-LT round on a transformer.  cfg: ModelConfig; quantization is
    the paper's uniform quantizer with static [vmin, vmax] (wire = level
    ints), as in the JAX package, whose fields these are."""

    cfg: object
    n_epochs: int = 2
    gamma: float = 0.02
    rho: float = 10.0
    levels: int = 255          # → uint8 wire
    vmin: float = -1.0
    vmax: float = 1.0
    compress: bool = True
    # pack the uplink ints of each tile-sized leaf into b-bit uint32 words
    pack_wire: bool = False
    # one fused quantize + EF + pack launch per tile-sized leaf, instead of
    # the quantizer and pack_bits; the words are equal either way
    fuse_pipeline: bool = True
    backend: str = "chunked"

    @property
    def wire_word_bits(self) -> int:
        return wire_index_bits(self.levels)

    @property
    def quant(self) -> dict:
        """The quantizer's arguments: levels, vmin, vmax."""
        return dict(levels=self.levels, vmin=self.vmin, vmax=self.vmax)

    # -- state ------------------------------------------------------------
    def init(self, n_agents: int, *, generator=None, device=None) -> DeployState:
        """Every agent starts from one draw of the model (the card unless
        ``device="cpu"``).  x and z start as one tensor per leaf, shared
        (the round never writes into a state it was given)."""
        p0 = init_params(self.cfg, generator=generator, device=device)
        xa = tree_map(lambda a: a[None].repeat((n_agents,) + (1,) * a.dim()), p0)
        return DeployState(x=xa, z=xa, c_up=tree_map(torch.zeros_like, xa), y_hat=p0,
                           c_down=tree_map(torch.zeros_like, p0), k=0)

    # -- pieces of a round --------------------------------------------------
    def local_train(self, x, v, batch):
        """N_e prox-gradient epochs per agent, agent by agent: (x_new, the
        last epoch's loss per agent (A,) float32)."""
        inv_rho = 1.0 / self.rho
        n_agents = tree_leaves(x)[0].shape[0]
        x_new = tree_map(torch.empty_like, x)
        losses = []
        for i in range(n_agents):
            w = tree_map(lambda a: a[i], x)
            v_i = tree_map(lambda a: a[i], v)
            batch_i = {k: t[i] for k, t in batch.items()}
            for _ in range(self.n_epochs):
                leaves = [t.detach().requires_grad_() for t in tree_leaves(w)]
                w = tree_unflatten(w, leaves)
                loss = lm_loss(w, self.cfg, batch_i, backend=self.backend)
                g = tree_unflatten(w, torch.autograd.grad(loss, leaves))
                with torch.no_grad():
                    w = tree_map(lambda wl, gl, vl: wl - self.gamma * (
                        gl + inv_rho * (wl - vl)).to(wl.dtype), w, g, v_i)
                del g, leaves
            tree_map(lambda dst, src: _local(dst)[i].copy_(_local(_like(src, dst[i]))),
                     x_new, w)
            losses.append(_whole(loss.detach()))
        return x_new, torch.stack(losses)

    def uplink_leaf(self, z, c, gather=None):
        """One parameter tensor (A, …) through uplink EF and the wire:
        (gathered wire floats in z's dtype, new EF cache).  With
        ``pack_wire``, a leaf of at least one tile takes one
        ``quant_pipeline`` launch (``fuse_pipeline``) or the quantizer and
        one ``pack_bits`` launch, then one ``unpack_bits`` per block of
        words; smaller leaves and ``pack_wire=False`` gather the plain level
        ints.  In the sharded round z and c are DTensors: this rank's shard
        is quantized and ``gather`` concatenates every agent rank's integer
        wire along dim 0 (the packed words as one block per rank)."""
        q, bits = self.quant, self.wire_word_bits
        zl, cl = _local(z), _local(c)
        if self.pack_wire and z.numel() >= _TILE_VALS:
            if self.fuse_pipeline:
                with record_function("fedlt.uplink.fused_pipeline"):
                    words, newc = ops.quant_pipeline(zl, cl, **q)
            else:
                w, newc = _quantize_ef(zl, cl, q)
                words = ops.pack_bits(w, bits)
                del w
            blocks = [words] if gather is None else gather(words[None]).unbind(0)
            del words
            idx = [ops.unpack_bits(b, bits, zl.numel()).reshape(zl.shape) for b in blocks]
            idx = idx[0] if len(idx) == 1 else torch.cat(idx)
            return quantize_decode(idx, dtype=z.dtype, **q), newc
        w, newc = _quantize_ef(zl, cl, q)
        return quantize_decode(w if gather is None else gather(w), dtype=z.dtype, **q), newc

    # -- one round ----------------------------------------------------------
    def round_step(self, state: DeployState, batch, agent_replicate_spec=None,
                   survivors=None):
        """batch: dict with a leading agent axis A on every tensor.

        ``survivors`` (optional ``(A,)`` bool): the quorum mask of a round
        closed at its deadline.  Excluded agents still train locally, but
        their wire is dropped from the coordinator mean and their uplink EF
        cache reverts to the full corrected message z + c_up, so their
        content telescopes into their next landed round.  Returns
        (new state, metrics).

        ``agent_replicate_spec``: the wire's gather target, a PartitionSpec
        tree like x's with the agent dim replicated (the JAX package's
        argument).  With DTensor state the round runs sharded (module
        docstring) and every leaf comes back in the placements it came in;
        with plain tensors nothing is sharded and the spec changes nothing,
        as in JAX on one device."""
        x0 = tree_leaves(state.x)[0]
        lay = _AgentLayout(x0) if is_dtensor(x0) else _Whole(x0)
        if agent_replicate_spec is not None:
            lay.check(state.x, agent_replicate_spec)
        surv, dropped = None, []
        if survivors is not None:
            surv = torch.as_tensor(survivors, dtype=torch.bool, device=_local(x0).device)
            mine = surv[lay.first:lay.first + lay.n_local].tolist()
            dropped = [i for i, kept in enumerate(mine) if not kept]

        def mask(t):
            return surv.reshape((-1,) + (1,) * (t.dim() - 1))

        def agent_mean(t):
            if surv is None:
                return t.mean(dim=0)
            n = surv.sum().clamp(min=1)
            return torch.where(mask(t), t, 0.0).to(t.dtype).sum(dim=0) / n.to(t.dtype)

        with lay.replicating():
            with record_function("fedlt.local_train"):
                with torch.no_grad():
                    v = tree_map(lambda y, z: _like((2.0 * y - z).to(z.dtype), z),
                                 state.y_hat, state.z)
                x_sub, losses = self.local_train(
                    tree_map(lay.to_sub, state.x), tree_map(lay.to_sub, v),
                    {k: lay.to_sub(t) for k, t in batch.items()})
                del v
                x_new = tree_map(lambda xs, x: lay.from_local(_local(xs), x),
                                 x_sub, state.x)
                del x_sub
                with torch.no_grad():
                    z_new = tree_map(lambda z, xn, y: _like(z + 2.0 * (xn - y), z),
                                     state.z, x_new, state.y_hat)

            with torch.no_grad():
                z_bar, c_up_new = [], []
                for z, c in zip(tree_leaves(z_new), tree_leaves(state.c_up)):
                    if not self.compress:
                        g = lay.gather(_local(z))
                    else:
                        with record_function("fedlt.uplink"):
                            g, nc = self.uplink_leaf(z, c, lay.gather)
                            _revert_caches(nc, _local(z), _local(c), dropped)
                        c_up_new.append(lay.from_local(nc, c))
                    with record_function("fedlt.aggregate"):
                        z_bar.append(lay.from_local(agent_mean(g), lay.mean_layout(z)))
                    del g
                z_bar = tree_unflatten(state.y_hat, z_bar)
                c_up_new = (tree_unflatten(state.c_up, c_up_new) if self.compress
                            else state.c_up)

                with record_function("fedlt.downlink"):
                    y = tree_map(lambda c, zb: _like(c + zb.to(c.dtype), c),
                                 state.c_down, z_bar)
                    del z_bar
                    if self.compress:
                        q = self.quant
                        y_hat = tree_map(lambda m: lay.from_local(quantize_decode(
                            _quantize_ef(_local(m), None, q)[0], dtype=m.dtype, **q), m), y)
                        c_down_new = tree_map(torch.sub, y, y_hat)
                    else:
                        y_hat, c_down_new = y, state.c_down

        new_state = DeployState(x=x_new, z=z_new, c_up=c_up_new, y_hat=y_hat,
                                c_down=c_down_new, k=state.k + 1)
        metrics = {"loss": lay.gather(losses).mean()}
        if surv is not None:
            metrics["quorum_frac"] = surv.sum().to(torch.float32) / surv.numel()
        if self.compress:
            # the exact uplink size per agent under the wire codec
            from ..wire.codecs import QuantCodec
            codec = QuantCodec(self.levels, self.vmin, self.vmax)
            per_agent = tree_map(lambda a: torch.empty(a.shape[1:], dtype=a.dtype,
                                                       device="meta"), state.x)
            metrics["wire_nbytes_per_agent"] = float(codec.tree_nbytes(per_agent))
        return new_state, metrics


# ---------------------------------------------------------------------------
# where the agents lie: plain tensors, or DTensors over a mesh
# ---------------------------------------------------------------------------

def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def _like(src, dst):
    """``src`` in ``dst``'s DTensor layout (plain tensors pass)."""
    if not is_dtensor(src):
        return src
    from ..launch.sharding import relayout
    return relayout(src, dst.placements)


_SIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16, torch.uint32: torch.int32}


class _Whole:
    """The agent layout of a plain state: every agent on this process, the
    identity wherever :class:`_AgentLayout` moves tensors."""

    first = 0

    def __init__(self, x0):
        self.n_local = x0.shape[0]

    def check(self, x, spec):
        pass

    def replicating(self):
        return contextlib.nullcontext()

    def to_sub(self, t):
        return t

    def from_local(self, loc, like):
        return loc

    def mean_layout(self, z):
        return None

    def gather(self, t):
        return t


class _AgentLayout:
    """Where the agents of a DTensor state lie: the mesh dims that shard the
    agent dim (dim 0 of every agent-stacked leaf, major to minor), the
    sub-mesh of the other dims, on which each rank's own agents train, and
    this rank's first agent."""

    def __init__(self, x0):
        from torch.distributed.tensor import Shard
        self.mesh = mesh = x0.device_mesh
        self.agent_dims = [i for i, p in enumerate(x0.placements) if p == Shard(0)]
        self.rest_dims = [i for i in range(mesh.ndim) if i not in self.agent_dims]
        rest = tuple(mesh.mesh_dim_names[i] for i in self.rest_dims)
        self.sub = None if not rest else mesh if len(rest) == mesh.ndim else mesh[rest]
        idx = 0
        for i in self.agent_dims:
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        self.n_local = x0.to_local().shape[0]
        self.first = idx * self.n_local

    def check(self, x, spec):
        """The gather target names only axes of the mesh, in its order."""
        from ..launch.sharding import placements
        tree_map(lambda _, sp: placements(sp, self.mesh), x, spec)

    def replicating(self):
        """The model's own plain tensors (RoPE tables, positions, masks)
        join the DTensors as replicated."""
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def to_sub(self, t):
        """A state or batch leaf as this rank's agents: a DTensor on the
        sub-mesh (or a plain tensor when every mesh dim holds agents).  A
        plain tensor holds every agent; this rank takes its own."""
        from torch.distributed.tensor import Replicate
        if not is_dtensor(t):
            loc = t[self.first:self.first + self.n_local]
            pl = [Replicate()] * len(self.rest_dims)
        else:
            loc, pl = t.to_local(), [t.placements[i] for i in self.rest_dims]
        if self.sub is None:
            return loc
        return DTensor.from_local(loc, self.sub, pl, run_check=False)

    def from_local(self, loc, like):
        """This rank's shard ``loc`` as a DTensor on the mesh, in the
        placements of ``like`` (a DTensor or the placements themselves)."""
        pl = like.placements if is_dtensor(like) else like
        return DTensor.from_local(loc, self.mesh, pl, run_check=False)

    def mean_layout(self, z):
        """The placements of the agent mean of agent-stacked ``z`` once its
        agents are gathered: the agent dims replicated, the weight dims
        sharded as in ``z``, one dim lower."""
        from torch.distributed.tensor import Replicate, Shard
        return [Replicate() if i in self.agent_dims else
                Shard(p.dim - 1) if isinstance(p, Shard) else p
                for i, p in enumerate(z.placements)]

    def gather(self, t):
        """Concatenate every agent rank's ``t`` along dim 0, in agent order
        (all-gathers over the agent dims, minor first); unsigned integers
        cross as the signed type of their width."""
        from torch.distributed import _functional_collectives as funcol
        gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
        signed = _SIGNED.get(t.dtype)
        out = t.view(signed) if signed is not None else t
        for i in reversed(self.agent_dims):
            if self.mesh.size(i) > 1:
                out = funcol.wait_tensor(gather(out.contiguous(), 0, (self.mesh, i)))
        return out.view(t.dtype) if signed is not None else out
