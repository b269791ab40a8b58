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
