"""Carry state between the JAX package and the port.

The two packages draw different random numbers from the same seed, so to
compute the same thing they must start from the same arrays.  These
helpers turn the JAX package's ``FedLTState``, ``DeployState``, data dict,
model parameter tree and KV-cache tree (any array type numpy can read)
into the port's tensors on a device, and back into numpy arrays.  The port's
:class:`~repro_torch.core.fedlt.FedLTState` has the JAX one's fields in
the same order, so ``repro.core.fedlt.FedLTState(*fedlt_state_to_numpy(s))``
rebuilds it; the port's caches have the JAX ones' fields in the same
order too.

Each leaf keeps its dtype.  numpy has no bfloat16 of its own (JAX hands
out ``ml_dtypes.bfloat16`` arrays), so a bf16 leaf goes through float32,
which holds every bf16 value exactly, and ``.to(torch.bfloat16)``; back
to numpy it comes as float32.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.deploy import DeployState
from .core.fedlt import FedLTState
from .core.pytree import tree_map
from .device import resolve_device
from .models.attention import KVCache, QuantKVCache
from .models.mamba2 import SSMCache
from .models.rwkv6 import RWKVCache


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (not a view: serving updates caches in place)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def data_from_numpy(data, device=None):
    """A data tree of arrays as tensors on ``device`` (the card by default)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), data)


def data_to_numpy(data):
    """Any tree of tensors (a data dict, model parameters) as numpy arrays."""
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


def deploy_state_from_jax(state, device=None) -> DeployState:
    """A deploy-mode state (fields x, z, c_up, y_hat, c_down, k, leaves as
    numpy arrays) as the port's :class:`DeployState` on ``device`` (the
    card by default); ``k`` becomes an int."""
    dev = resolve_device(device)
    t = lambda tree: tree_map(lambda x: _tensor(x, dev), tree)
    return DeployState(x=t(state.x), z=t(state.z), c_up=t(state.c_up),
                       y_hat=t(state.y_hat), c_down=t(state.c_down),
                       k=int(np.asarray(state.k)))


def deploy_state_to_numpy(state: DeployState) -> DeployState:
    """The port's deploy state with numpy leaves and ``k`` as an int32
    scalar: ``repro.core.deploy.DeployState(*deploy_state_to_numpy(s))``
    rebuilds the JAX package's (bf16 leaves come back as float32)."""
    a = lambda tree: tree_map(_array, tree)
    return DeployState(x=a(state.x), z=a(state.z), c_up=a(state.c_up),
                       y_hat=a(state.y_hat), c_down=a(state.c_down),
                       k=np.asarray(state.k, np.int32))


def model_params_from_jax(params, device=None):
    """A model parameter tree of arrays (``repro.models.transformer``'s
    ``init_params``, as numpy) as the port's tensors on ``device``; back
    with :func:`data_to_numpy`."""
    return data_from_numpy(params, device)


_CACHE_TYPES = {c._fields: c for c in (KVCache, QuantKVCache, SSMCache, RWKVCache)}


def _length(x) -> int:
    vals = np.unique(np.asarray(x))
    if vals.size != 1:
        raise ValueError(f"layers of one cache disagree on its length: {vals}")
    return int(vals[0])


def kv_cache_from_jax(cache, device=None):
    """A serving cache tree (``{"scan", "tail", "length"}`` of the JAX
    package's ``KVCache``/``QuantKVCache``/``SSMCache``/``RWKVCache``,
    arrays as numpy) as the port's caches on ``device``; every ``length``
    becomes a Python int."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: (_length(v) if k == "length" else conv(v))
                    for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields in _CACHE_TYPES:
            kw = {f: _length(getattr(node, f)) if f == "length"
                  else _tensor(getattr(node, f), dev) for f in fields}
            return _CACHE_TYPES[fields](**kw)
        if isinstance(node, (tuple, list)):
            return type(node)(conv(c) for c in node)
        return _tensor(node, dev)

    return conv(cache)


def kv_cache_to_numpy(cache):
    """The port's cache tree with numpy leaves, shaped as the JAX package's:
    a layer's ``length`` an int32 scalar, a stacked slot's one per repeat,
    the tree's an int32 scalar."""
    def length(n: int, pos) -> np.ndarray:
        return np.full(pos.shape[:-1], n, np.int32)

    def conv(node):
        if isinstance(node, dict):
            return {k: (np.asarray(v, np.int32) if k == "length" else conv(v))
                    for k, v in node.items()}
        if isinstance(node, (KVCache, QuantKVCache)):
            return node._replace(**{f: _array(getattr(node, f))
                                    for f in node._fields if f != "length"},
                                 length=length(node.length, node.pos))
        if isinstance(node, (SSMCache, RWKVCache)):
            return type(node)(*map(_array, node))
        if isinstance(node, (tuple, list)):
            return type(node)(conv(c) for c in node)
        return _array(node)

    return conv(cache)
