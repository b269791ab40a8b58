"""Algorithm-agnostic error feedback (paper Fig. 3).

A *channel* wraps the uplink or downlink of any federated algorithm.
Every transmission adds the locally cached compression error to the
message, compresses, caches the new error, and puts the compressed
message on the wire:

    wire      = C(msg + cache)
    new_cache = msg + cache − wire

With a δ-approximate compressor the cache stays bounded, and the
telescoping sum of wires equals the sum of messages minus the final cache
(paper §2.2).  :class:`EFChannel` carries no state; the cache tree is
passed in and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..kernels import ops
from .compression import (Compressor, Identity, UniformQuantizer,
                          quantize_decode, wire_index_bits)
from .pytree import (tree_add, tree_leaves, tree_map, tree_sub,
                     tree_unflatten, tree_zeros_like)


@dataclasses.dataclass(frozen=True)
class EFChannel:
    """One direction of communication (uplink or downlink) with EF.

    ``enabled=False`` degrades to plain compression (Algorithm 1) with the
    same state signature, so Algorithms 1 and 2 are one code path with a
    flag, as in the paper's Table 1 ablation.
    """

    compressor: Compressor = Identity()
    enabled: bool = True

    def init_cache(self, msg_like):
        return tree_zeros_like(msg_like)

    def send(self, gen, msg, cache, batch: bool = False) -> Tuple[object, object]:
        """Returns (wire, new_cache).  With ``batch=True`` the leading axis
        of every leaf indexes agents, each compressed as its own message."""
        if not self.enabled:
            return self.compressor(gen, msg, batch), cache
        corrected = tree_add(msg, cache)
        wire = self.compressor(gen, corrected, batch)
        return wire, tree_sub(corrected, wire)

    # -- fused pipeline fast path ------------------------------------------
    def fusable(self) -> bool:
        """True when :meth:`send_fused` can replace :meth:`send`: EF on and
        a clip=True uniform quantizer (clip=False lattice points outside
        [vmin, vmax] have no on-wire index)."""
        return (self.enabled and isinstance(self.compressor, UniformQuantizer)
                and self.compressor.clip)

    def send_fused(self, msg, cache) -> Tuple[object, object]:
        """One fused compress→EF→pack kernel per leaf over the whole
        (agent-stacked) tree, then the decode of the packed words.

        The same channel as :meth:`send` for a fusable channel (the
        quantizer is deterministic, so no generator): the wire floats are
        the decode of the exact words a transmitter would put on the link.
        """
        C = self.compressor
        bits = wire_index_bits(C.levels)

        def leaf(m, c):
            words, newc = ops.quant_pipeline(m, c, levels=C.levels,
                                             vmin=C.vmin, vmax=C.vmax)
            idx = ops.unpack_bits(words, bits, m.numel())
            wire = quantize_decode(idx, C.levels, C.vmin, C.vmax,
                                   torch.float32).to(m.dtype).reshape(m.shape)
            return wire, newc

        pairs = [leaf(m, c) for m, c in zip(tree_leaves(msg), tree_leaves(cache))]
        return (tree_unflatten(msg, [w for w, _ in pairs]),
                tree_unflatten(msg, [nc for _, nc in pairs]))


def resync_cache(cache, crashed):
    """Re-sync the EF residuals of crashed satellites to zero.

    A crash wipes the satellite's memory, so it reboots with an empty
    cache (unlike a link erasure, where the residual is kept).  ``crashed``
    is an ``(N,)`` bool mask over the cache's leading agent axis.
    """
    def leaf(c):
        m = torch.as_tensor(crashed, dtype=torch.bool, device=c.device)
        return torch.where(m.reshape((-1,) + (1,) * (c.ndim - 1)),
                           torch.zeros_like(c), c)

    return tree_map(leaf, cache)


@dataclasses.dataclass(frozen=True)
class GroupedEFChannel:
    """Error feedback with residuals held at aggregation *heads* instead
    of at the leaves.

    Under an in-orbit aggregation topology (``repro_torch.sim.topology``)
    the members of an orbital plane merge their raw updates at an elected
    cluster head, and only the head's merged wire crosses the
    ground-station bottleneck.  That opens a second EF placement: keep
    ONE residual per *group* (plane) at the head, applied to the merged
    sum right before the uplink:

        group_msg_g = Σ_{i ∈ g} msg_i
        wire_g      = C(group_msg_g + cache_g)
        cache_g'    = group_msg_g + cache_g − wire_g

    Group membership is an ``(N,)`` int tensor of group ids (``-1`` =
    inactive this round, contributes nothing); the cache carries a leading
    group axis of static size ``n_groups``, so membership can change every
    round while the per-group residual stays put.  The sum of landed wires
    plus the final cache equals the sum of everything the group's members
    ever offered.  A destroyed head uplink puts the discharged content back
    (:meth:`revert`), the leaf analogue of
    ``repro_torch.core.fedlt_sat._revert_lost_wires``.
    """

    compressor: Compressor = Identity()
    enabled: bool = True

    def init_cache(self, msg_like, n_groups: int):
        """Zero residuals: one slot per group, member shapes minus the
        leading agent axis (``msg_like`` is agent-stacked)."""
        return tree_map(lambda x: torch.zeros((n_groups,) + tuple(x.shape[1:]),
                                              dtype=x.dtype, device=x.device),
                        msg_like)

    def group_sum(self, msgs, groups, n_groups: int):
        """Merge agent-stacked messages into per-group sums (``index_add_``,
        JAX's ``segment_sum``); rows of group ``-1`` add zero."""
        def leaf(x):
            g = torch.as_tensor(groups, device=x.device).to(torch.int64)
            live = (g >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
            out = torch.zeros((n_groups,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            return out.index_add_(0, g.clamp(min=0),
                                  torch.where(live, x, 0).to(x.dtype))

        return tree_map(leaf, msgs)

    def send(self, gen, msgs, cache, groups, n_groups: int):
        """Merge → correct → compress at the heads: ``(wire, new_cache)``,
        both with a leading group axis.  A group with no live member this
        round still discharges its cached residual."""
        gsum = self.group_sum(msgs, groups, n_groups)
        if not self.enabled:
            return self.compressor(gen, gsum), cache
        corrected = tree_add(gsum, cache)
        wire = self.compressor(gen, corrected)
        return wire, tree_sub(corrected, wire)

    def revert(self, new_cache, wire, lost):
        """For each group of the ``(n_groups,)`` bool mask ``lost`` the wire
        never landed, so its content goes back into the residual:
        ``cache + wire`` is the corrected message the next send re-offers."""
        def leaf(c, w):
            m = torch.as_tensor(lost, dtype=torch.bool, device=c.device)
            return torch.where(m.reshape((-1,) + (1,) * (c.dim() - 1)), c + w, c)

        return tree_map(leaf, new_cache, wire)
