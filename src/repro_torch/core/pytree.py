"""Tree arithmetic helpers used throughout the federated core.

Federated state (models x_i, auxiliaries z_i, EF caches c_i, the
coordinator aggregate y) is a tree of tensors: dicts, tuples, lists and
NamedTuples nest, anything else is a leaf.  Per-agent quantities carry a
leading agent axis.  Dict keys are visited in sorted order, as JAX's
pytrees do, so leaf order matches the JAX package's.
"""
from __future__ import annotations

import torch

Tree = object  # any tree of tensors


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(f, tree, *rest):
    """Apply ``f`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(f, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(f, *xs) for xs in zip(tree, *rest))
    return f(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the order :func:`tree_map` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_flatten_with_names(tree) -> tuple:
    """``(names, leaves)`` in :func:`tree_leaves` order, each name the path
    to its leaf as ``jax.tree_util.keystr`` spells it: ``.x`` for a
    NamedTuple field, ``['k']`` for a dict key, ``[0]`` for a sequence
    index (``.x['w']``, ``.extra[0]``; ``''`` for a bare leaf)."""
    names, leaves = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif _is_namedtuple(node):
            for field, v in zip(node._fields, node):
                walk(v, f"{path}.{field}")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            names.append(path)
            leaves.append(node)

    walk(tree, "")
    return names, leaves


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, a, b):
    """s * a + b."""
    return tree_map(lambda x, y: s * x + y, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_vdot(a, b):
    """Σ over leaves of ⟨a, b⟩ (``jnp.vdot`` per leaf, flattened)."""
    return sum(tree_leaves(tree_map(lambda x, y: torch.vdot(x.reshape(-1),
                                                            y.reshape(-1)), a, b)))


def tree_sq_norm(a):
    return tree_vdot(a, a)


def tree_norm(a):
    return torch.sqrt(tree_sq_norm(a))


def tree_mean_axis0(a):
    """Mean over the leading (agent) axis of every leaf."""
    return tree_map(lambda x: torch.mean(x, dim=0), a)


def tree_sum_axis0(a):
    return tree_map(lambda x: torch.sum(x, dim=0), a)


def tree_where_mask(mask, a, b):
    """Select per agent: leaves of a/b have a leading agent axis; mask (N,)."""

    def sel(x, y):
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(m, x, y)

    return tree_map(sel, a, b)


def tree_broadcast_agents(a, n_agents: int):
    """Tile a coordinator tree to a per-agent stacked tree (a broadcast
    view, as ``jnp.broadcast_to``)."""
    return tree_map(lambda x: x[None].expand((n_agents,) + tuple(x.shape)), a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_split_keys(gen: torch.Generator, tree):
    """One ``torch.Generator`` per leaf, each seeded from a draw of ``gen``.

    The counterpart of splitting a JAX PRNG key per leaf.  The streams are
    not JAX's: the same seed gives other numbers than ``jax.random``, so
    tests that compare the two packages feed both the same inputs.
    """
    def child(_):
        g = torch.Generator(device=gen.device)
        g.manual_seed(int(torch.randint(0, 2**62, (), generator=gen,
                                        device=gen.device)))
        return g

    return tree_map(child, tree)
