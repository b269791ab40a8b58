"""Sharding rules: parameter/state/batch trees → PartitionSpec trees.

Counterpart of ``repro.launch.sharding``, rule for rule.  The same rule
table serves every architecture; a dimension is only sharded when the mesh
axis size divides it (checked here, so misconfigured configs fail loudly
at spec-construction time).

Layout summary (deploy mode):
  * agent-stacked leaves get their leading agent dim sharded over the agent
    mesh axes ("pod","data" or "pod");
  * 2-D weights: input-major  (d_in, d_out)  → (fsdp, tp)
                 output-major (d_out, d_in)  → (tp, fsdp)
  * MoE expert stacks (E, d, f) → (None, fsdp, tp) / (E, f, d) → (None, tp, fsdp)
  * embeddings (V, D) → (tp, fsdp); LM head (D, V) → (fsdp, tp)
  * norms / scalars / tiny tensors → replicated
  * scan-stacked layer dims → replicated (leading axis of stacked blocks)

JAX's tools map onto ``torch.distributed``'s: a :class:`PartitionSpec` is a
tuple with one entry per tensor dim (an axis name, a tuple of names, or
``None``) whose ``str()`` is JAX's; :func:`placements` turns it into DTensor
placements on a ``DeviceMesh`` (``Shard(d)`` on each mesh dim that the spec
names at tensor dim d, else ``Replicate()``), :func:`distribute` is
``device_put`` with a ``NamedSharding``, and :func:`constrain` is
``with_sharding_constraint``: ``DTensor.redistribute`` on a DTensor, the
identity on a plain tensor (what JAX does on one device).  The rules read
only axis names and sizes, so an :class:`~.mesh.AbstractMesh` serves them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.pytree import _is_namedtuple, tree_map
from ..device import is_dtensor
from .mesh import axis_size, mesh_axes

# weight name → (row_role, col_role); roles: f=fsdp, t=tp, r=replicated
_2D_RULES = {
    "wq": "ft", "wk": "ft", "wv": "ft", "wo": "tf",
    "up": "ft", "gate": "ft", "down": "tf",
    "router": "fr", "in_proj": "ft", "out_proj": "tf",
    "ck": "ft", "cv": "tf", "cr": "ft", "wr": "ft", "wg": "ft",
    "mix_lora_a": "fr", "mix_lora_b": "rt",
    "decay_lora_a": "fr", "decay_lora_b": "rt",
    "table": "tf", "lm_head": "ft", "pos_table": "rt",
    "conv_w": "rt",
}

_3D_MOE = {"up": "rft", "gate": "rft", "down": "rtf"}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (the
    dim sharded over all of them, major to minor) or ``None``; ``str()``
    is JAX's (``PartitionSpec(None, 'data', 'model')``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        inner = ", ".join(repr(e) for e in self)
        return f"PartitionSpec({inner}{',' if len(self) == 1 else ''})"

    __str__ = __repr__


P = PartitionSpec


# ---------------------------------------------------------------------------
# tree walking with paths (the reference's tree_map_with_path)
# ---------------------------------------------------------------------------

def _map_with_path(f, tree, path=()):
    """``f(path, leaf)`` over ``tree`` in :func:`~..core.pytree.tree_map`'s
    order; ``path`` holds ``("key", k)`` for a dict key, ``("name", field)``
    for a NamedTuple field and ``("idx", i)`` for a sequence index, as
    JAX's ``DictKey``/``GetAttrKey``/``SequenceKey``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(f, tree[k], path + (("key", k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(f, v, path + (("name", n),))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(f, v, path + (("idx", i),))
                          for i, v in enumerate(tree))
    return f(path, tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return axis_size(mesh, name)


def _role_axis(role: str, fsdp, tp):
    return {"f": fsdp, "t": tp, "r": None}[role]


def _maybe(axis, dim: int, mesh) -> Optional[str]:
    """Shard dim over axis only if divisible (axis may be a tuple)."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        total = int(np.prod([_axis_size(mesh, a) for a in axis]))
        return axis if total and dim % total == 0 else None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _leaf_spec(path, shape, mesh, *, fsdp, tp, n_lead: int = 0):
    """n_lead: number of leading non-weight dims (agent and/or scan stacking)
    whose specs are provided by the caller."""
    keys = [v for kind, v in path if kind in ("key", "name") and isinstance(v, str)]
    name = keys[-1] if keys else ""
    core = shape[n_lead:]
    nd = len(core)

    if nd <= 1:
        return (None,) * nd
    rule = None
    if nd == 2 and name in _2D_RULES:
        rule = _2D_RULES[name]
    elif nd == 3 and name in _3D_MOE:
        rule = _3D_MOE[name]
    if rule is None:
        return (None,) * nd
    return tuple(_maybe(_role_axis(role, fsdp, tp), dim, mesh)
                 for role, dim in zip(rule, core))


# ---------------------------------------------------------------------------
# Fleet axis: shard the federated agent dimension across ranks.
# ---------------------------------------------------------------------------

def fleet_mesh(n_devices: Optional[int] = None, *, axis: str = "fleet",
               device=None):
    """1-D mesh over the default process group's ranks for sharding the
    agent dimension.

    Returns ``None`` on a single device (no process group, or one of one
    rank): the caller keeps the unsharded path (``FedLT.round``); with
    more ranks the returned ``DeviceMesh`` feeds ``FedLT.round_sharded``
    and :func:`shard_fleet`.
    """
    import torch.distributed as dist

    from .mesh import _device_mesh

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices <= 1:
        return None
    return _device_mesh((n_devices,), (axis,), device)


def fleet_specs(tree, mesh, *, axis: str = "fleet",
                n_agents: Optional[int] = None):
    """PartitionSpec tree sharding each leaf's leading (agent) dim over the
    fleet axis.

    ``n_agents`` identifies the agent axis: only leaves whose leading dim
    EQUALS it shard (pass it whenever the tree mixes agent-stacked and
    coordinator leaves, e.g. ``FedLTState``, whose ``c_down`` has no
    agent dim and must stay replicated even if its feature dim happens to
    divide the device count).  Without ``n_agents``, any leaf whose
    leading dim the axis size divides is treated as agent-stacked.
    Non-divisible leading dims and scalars stay replicated either way.
    """
    n_dev = axis_size(mesh, axis)

    def spec(leaf):
        shape = _shape(leaf)
        if not shape or shape[0] % n_dev:
            return P()
        if n_agents is not None and shape[0] != n_agents:
            return P()
        return P(axis)

    return tree_map(spec, tree)


def shard_fleet(tree, mesh, *, axis: str = "fleet",
                n_agents: Optional[int] = None):
    """Place agent-stacked leaves as DTensors with the leading dim sharded
    over the fleet axis, the rest replicated (``mesh=None``, the single
    device, returns ``tree`` itself); see :func:`fleet_specs` for why
    ``n_agents`` should be passed for mixed trees like ``FedLTState``.
    Non-tensor leaves (the round counter) pass through."""
    if mesh is None:
        return tree
    specs = fleet_specs(tree, mesh, axis=axis, n_agents=n_agents)
    return tree_map(lambda x, s: distribute(x, mesh, s), tree, specs)


def param_specs(params_shape, mesh, *, agent_axes: Tuple[str, ...] = (),
                stacked: Optional[bool] = None, fsdp="data", tp="model"):
    """PartitionSpec tree for a parameter tree (leaves: tensors, meta
    tensors or anything with a ``shape``).

    stacked: leaves carry a leading agent dim (replicated when agent_axes is
    empty, e.g. a single pod-agent on the single-pod mesh).  Defaults to
    bool(agent_axes).  Scan-stacked leaves (under the "scan" top-level key)
    get one extra replicated leading dim.
    """
    if stacked is None:
        stacked = bool(agent_axes)
    agent = tuple(agent_axes) if agent_axes else None
    if agent is not None and len(agent) == 1:
        agent = agent[0]

    def spec_for(path, leaf):
        shape = _shape(leaf)
        keys = [v if kind == "key" else None for kind, v in path]
        n_lead = 0
        lead = []
        if stacked:
            lead.append(None if agent is None else _maybe(agent, shape[0], mesh))
            n_lead += 1
        if keys and keys[0] == "scan":
            lead.append(None)
            n_lead += 1
        core = _leaf_spec(path, shape, mesh, fsdp=fsdp, tp=tp, n_lead=n_lead)
        return P(*lead, *core)

    return _map_with_path(spec_for, params_shape)


def batch_specs(batch_shape, mesh, *, agent_axes: Tuple[str, ...] = (),
                stacked: Optional[bool] = None, data="data"):
    """Batch tree: leading agent dim (if stacked) over agent axes, then the
    batch dim over the remaining data axes; everything else replicated."""
    if stacked is None:
        stacked = bool(agent_axes)
    agent = tuple(agent_axes)
    # data axes not used by the agent dim
    names = [n for n in mesh_axes(mesh) if n in ("pod", "data")]
    rest = tuple(n for n in names if n not in agent)
    agent_spec = (agent if len(agent) > 1 else (agent[0] if agent else None))
    rest_spec = (rest if len(rest) > 1 else (rest[0] if rest else None))

    def spec_for(path, leaf):
        shape = _shape(leaf)
        dims = []
        i = 0
        if stacked:
            dims.append(None if not agent else _maybe(agent_spec, shape[0], mesh))
            i = 1
        if len(shape) > i:
            dims.append(_maybe(rest_spec, shape[i], mesh))
        dims += [None] * (len(shape) - len(dims))
        return P(*dims)

    return _map_with_path(spec_for, batch_shape)


def cache_specs(cache_shape, mesh, *, tp="model", seq_axis="data",
                shard_batch=True):
    """KV / SSM cache specs for serving.

    KV leaves (B, S, H, D): batch over pod+data when divisible, else the
    sequence dim over "data" (long-context batch=1 case) and heads over tp.
    """
    names = [n for n in mesh_axes(mesh) if n in ("pod", "data")]
    dp = tuple(names) if len(names) > 1 else (names[0] if names else None)

    def core_spec(name, shape):
        if len(shape) == 4 and name in ("k", "v"):     # (B, S, Hkv, D)
            b, s, h, d = shape
            if shard_batch and _maybe(dp, b, mesh):
                return (_maybe(dp, b, mesh), None, _maybe(tp, h, mesh), None)
            return (None, _maybe(seq_axis, s, mesh), _maybe(tp, h, mesh), None)
        if len(shape) == 4 and name == "state":         # (B, H, P, N)
            b = shape[0]
            if shard_batch and _maybe(dp, b, mesh):
                return (_maybe(dp, b, mesh), None, None, None)
            return (None,) * 4
        if len(shape) == 3 and name in ("k_scale", "v_scale"):  # (B, S, Hkv)
            b, s, h = shape
            if shard_batch and _maybe(dp, b, mesh):
                return (_maybe(dp, b, mesh), None, _maybe(tp, h, mesh))
            return (None, _maybe(seq_axis, s, mesh), _maybe(tp, h, mesh))
        if name in ("conv", "last_t", "last_c") and len(shape) >= 1:
            b = shape[0]
            if shard_batch and _maybe(dp, b, mesh):
                return (_maybe(dp, b, mesh),) + (None,) * (len(shape) - 1)
            return (None,) * len(shape)
        return (None,) * len(shape)

    def spec_for(path, leaf):
        str_keys = [v for kind, v in path if kind in ("key", "name")
                    and isinstance(v, str)]
        name = str_keys[-1] if str_keys else ""
        scan_stacked = bool(str_keys) and str_keys[0] == "scan"
        shape = _shape(leaf)
        shape = shape[1:] if scan_stacked else shape
        core = core_spec(name, shape)
        return P(None, *core) if scan_stacked else P(*core)

    return _map_with_path(spec_for, cache_shape)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh: DTensor placements
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that the spec names at tensor dim d, else ``Replicate()``.  A tuple
    entry shards its dim over its axes major to minor, which is DTensor's
    order for several mesh dims on one tensor dim and JAX's
    ``NamedSharding``'s, so it must list them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a not in names for a in axes):
            raise ValueError(f"{spec}: {axes} are not all axes of the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {d} must follow the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(placements_, mesh) -> PartitionSpec:
    """The :class:`PartitionSpec` of DTensor placements (no ``Partial``)."""
    from torch.distributed.tensor import Shard

    names = mesh_axes(mesh)
    dims = {}
    for name, p in zip(names, placements_):
        if isinstance(p, Shard):
            dims.setdefault(p.dim, []).append(name)
    n = max(dims, default=-1) + 1
    return P(*(None if d not in dims else
               (dims[d][0] if len(dims[d]) == 1 else tuple(dims[d]))
               for d in range(n)))


def distribute(x, mesh, spec):
    """``x`` as a DTensor on ``mesh`` under ``spec`` (JAX's ``device_put``
    with a ``NamedSharding``): every rank passes the same full tensor and
    keeps its own shard of it, with no communication when the spec's axes
    divide their dims (the rules shard no other), else through
    ``distribute_tensor``.  A non-tensor leaf passes through."""
    import torch
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    if not isinstance(x, torch.Tensor):
        return x
    pl = placements(spec, mesh)
    local = x
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n, size = mesh.size(i), local.shape[p.dim]
            if size % n:
                return distribute_tensor(x, mesh, pl)
            size //= n
            local = local.narrow(p.dim, mesh.get_local_rank(i) * size, size)
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def local_shape(shape, mesh, spec) -> tuple:
    """The shape of each rank's shard of a ``shape`` tensor under ``spec``
    (the spec's axes divide their dims)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements(spec, mesh)):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def full_on_mesh(shape, fill, dtype, device, mesh, spec):
    """A ``shape`` DTensor filled with ``fill``, laid out by ``spec``: each
    rank allocates only its own shard (no global tensor anywhere)."""
    import torch
    from torch.distributed.tensor import DTensor
    local = torch.full(local_shape(shape, mesh, spec), fill, dtype=dtype, device=device)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def constrain(x, spec):
    """``with_sharding_constraint``: a DTensor redistributed to ``spec`` on
    its own mesh; a plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    return relayout(x, placements(spec, x.device_mesh))


def relayout(t, placements_):
    """DTensor ``t`` in ``placements_`` on its own mesh (redistributed only
    where its placements differ)."""
    if tuple(t.placements) == tuple(placements_):
        return t
    return t.redistribute(t.device_mesh, placements_)


def as_dtensors(*ts):
    """The mesh of the first DTensor among ``ts``, and each of ``ts`` as a
    DTensor on it: a plain tensor joins as replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next(t for t in ts if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    return mesh, tuple(t if is_dtensor(t) else
                       DTensor.from_local(t, mesh, rep, run_check=False) for t in ts)


def map_local(fn, ts, in_placements, out_placements, grad_placements=None):
    """``fn`` on the local shards of the DTensors ``ts``, each first laid
    out in its entry of ``in_placements`` (``local_map``; autograd goes
    through the local call).  ``grad_placements``: the gradients' layouts
    where they differ from the inputs', as for an input replicated over a
    mesh dim whose ranks each read a part of it (their gradients are
    ``Partial`` there)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = ts[0].device_mesh
    ts = [relayout(t, tuple(pl)) for t, pl in zip(ts, in_placements)]
    # placements as lists: local_map reads a tuple as one entry per output
    return local_map(fn, out_placements=list(out_placements),
                     in_placements=tuple(list(pl) for pl in in_placements),
                     in_grad_placements=(None if grad_placements is None else
                                         tuple(list(pl) for pl in grad_placements)),
                     device_mesh=mesh)(*ts)
