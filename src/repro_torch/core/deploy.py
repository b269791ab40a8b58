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
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..kernels import ops
from ..kernels.pack_bits import _TILE_VALS
from ..models.transformer import init_params, lm_loss
from .compression import quantize_decode, quantize_encode, wire_index_bits
from .pytree import tree_leaves, tree_map, tree_unflatten


def _quantize_ef(z, c, q):
    """Level ints of z + c, formed in float32, and the new EF cache in z's
    dtype; with ``c`` None, the level ints of z alone."""
    if c is None:
        return quantize_encode(z.to(torch.float32), **q), None
    m = z.to(torch.float32) + c
    w = quantize_encode(m, **q)
    m -= quantize_decode(w, **q)
    return w, m.to(z.dtype)


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
            tree_map(lambda dst, src: dst[i].copy_(src), x_new, w)
            losses.append(loss.detach())
        return x_new, torch.stack(losses)

    def uplink_leaf(self, z, c):
        """One parameter tensor (A, …) through uplink EF and the wire:
        (gathered wire floats in z's dtype, new EF cache).  With
        ``pack_wire``, a leaf of at least one tile takes one
        ``quant_pipeline`` launch (``fuse_pipeline``) or the quantizer and
        one ``pack_bits`` launch, then one ``unpack_bits``; smaller leaves
        and ``pack_wire=False`` gather the plain level ints."""
        q, bits = self.quant, self.wire_word_bits
        packed = self.pack_wire and z.numel() >= _TILE_VALS
        if packed and self.fuse_pipeline:
            with record_function("fedlt.uplink.fused_pipeline"):
                words, newc = ops.quant_pipeline(z, c, **q)
            idx = ops.unpack_bits(words, bits, z.numel())
            del words
            return quantize_decode(idx, dtype=z.dtype, **q).reshape(z.shape), newc
        w, newc = _quantize_ef(z, c, q)
        if packed:
            w = ops.unpack_bits(ops.pack_bits(w, bits), bits, w.numel()).reshape(w.shape)
        return quantize_decode(w, dtype=z.dtype, **q), newc

    # -- one round ----------------------------------------------------------
    def round_step(self, state: DeployState, batch, agent_replicate_spec=None,
                   survivors=None):
        """batch: dict with a leading agent axis A on every tensor.

        ``survivors`` (optional ``(A,)`` bool): the quorum mask of a round
        closed at its deadline.  Excluded agents still train locally, but
        their wire is dropped from the coordinator mean and their uplink EF
        cache reverts to the full corrected message z + c_up, so their
        content telescopes into their next landed round.  Returns
        (new state, metrics)."""
        if agent_replicate_spec is not None:
            raise NotImplementedError(
                "agent_replicate_spec shards the agent axis over a mesh: it needs the "
                "port's launch/ slice (mesh.py, sharding.py), ROADMAP Queue 1, "
                "the launch/ item")
        surv = None
        if survivors is not None:
            surv = torch.as_tensor(survivors, dtype=torch.bool,
                                   device=tree_leaves(state.x)[0].device)

        def mask(t):
            return surv.reshape((-1,) + (1,) * (t.dim() - 1))

        def agent_mean(t):
            if surv is None:
                return t.mean(dim=0)
            n = surv.sum().clamp(min=1)
            return torch.where(mask(t), t, 0.0).to(t.dtype).sum(dim=0) / n.to(t.dtype)

        with record_function("fedlt.local_train"):
            with torch.no_grad():
                v = tree_map(lambda y, z: (2.0 * y - z).to(z.dtype), state.y_hat,
                             state.z)
            x_new, last_loss = self.local_train(state.x, v, batch)
            del v
            with torch.no_grad():
                z_new = tree_map(lambda z, xn, y: z + 2.0 * (xn - y), state.z, x_new,
                                 state.y_hat)

        with torch.no_grad():
            if self.compress:
                leaves_z = tree_leaves(z_new)
                z_bar, c_up_new = [], []
                for z, c in zip(leaves_z, tree_leaves(state.c_up)):
                    with record_function("fedlt.uplink"):
                        g, nc = self.uplink_leaf(z, c)
                        if surv is not None:
                            nc = torch.where(mask(nc), nc, z + c).to(nc.dtype)
                    with record_function("fedlt.aggregate"):
                        z_bar.append(agent_mean(g))
                    c_up_new.append(nc)
                    del g
                z_bar = tree_unflatten(state.y_hat, z_bar)
                c_up_new = tree_unflatten(state.c_up, c_up_new)
            else:
                c_up_new = state.c_up
                with record_function("fedlt.aggregate"):
                    z_bar = tree_map(agent_mean, z_new)

            with record_function("fedlt.downlink"):
                y = tree_map(lambda c, zb: c + zb.to(c.dtype), state.c_down, z_bar)
                del z_bar
                if self.compress:
                    q = self.quant
                    y_hat = tree_map(lambda m: quantize_decode(
                        _quantize_ef(m, None, q)[0], dtype=m.dtype, **q), y)
                    c_down_new = tree_map(torch.sub, y, y_hat)
                else:
                    y_hat, c_down_new = y, state.c_down

        new_state = DeployState(x=x_new, z=z_new, c_up=c_up_new, y_hat=y_hat,
                                c_down=c_down_new, k=state.k + 1)
        metrics = {"loss": last_loss.mean()}
        if surv is not None:
            metrics["quorum_frac"] = surv.sum().to(torch.float32) / surv.numel()
        if self.compress:
            # the exact uplink size per agent under the wire codec
            from ..wire.codecs import QuantCodec
            codec = QuantCodec(self.levels, self.vmin, self.vmax)
            metrics["wire_nbytes_per_agent"] = float(
                codec.tree_nbytes(tree_map(lambda a: a[0], state.x)))
        return new_state, metrics
