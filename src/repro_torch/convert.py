"""Carry state between the JAX package and the port.

The two packages draw different random numbers from the same seed, so to
compute the same thing they must start from the same arrays.  These
helpers turn the JAX package's ``FedLTState`` and data dict (any array
type numpy can read) into the port's tensors on a device, and back into
numpy arrays.  The port's :class:`~repro_torch.core.fedlt.FedLTState`
has the JAX one's fields in the same order, so
``repro.core.fedlt.FedLTState(*fedlt_state_to_numpy(s))`` rebuilds it.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.fedlt import FedLTState
from .core.pytree import tree_map
from .device import resolve_device


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def data_from_numpy(data, device=None):
    """A data tree of arrays as tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), data)


def data_to_numpy(data):
    return tree_map(_array, data)


def fedlt_state_from_numpy(state, device=None) -> FedLTState:
    """A Fed-LT state (fields x, z, c_up, z_hat, c_down, k) as the port's
    :class:`FedLTState` on ``device`` (the card by default)."""
    dev = resolve_device(device)
    t = lambda tree: tree_map(lambda x: _tensor(x, dev), tree)
    return FedLTState(x=t(state.x), z=t(state.z), c_up=t(state.c_up),
                      z_hat=t(state.z_hat), c_down=t(state.c_down),
                      k=int(np.asarray(state.k)))


def fedlt_state_to_numpy(state: FedLTState) -> FedLTState:
    """The port's state with numpy leaves and ``k`` as an int32 scalar."""
    a = lambda tree: tree_map(_array, tree)
    return FedLTState(x=a(state.x), z=a(state.z), c_up=a(state.c_up),
                      z_hat=a(state.z_hat), c_down=a(state.c_down),
                      k=np.asarray(state.k, np.int32))
