"""Production mesh construction on ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  The meshes are built by functions:
importing this module touches no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller creates (``dist.init_process_group`` with its
address, world size and rank); where spec rules need only the axis names
and sizes, an :class:`AbstractMesh` stands in, as JAX's ``AbstractMesh``
does, with no process group at all.

``DeviceMesh.shape`` is a tuple where JAX's ``mesh.shape`` is a dict by
name; :func:`axis_size` reads an axis's size from either kind.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple


class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices and no process
    group: what the sharding rules read (``AbstractMesh((16, 16),
    ("data", "model"))``, as in JAX)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                             "differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)

    def size(self, dim=None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names, major to minor."""
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return int(mesh.shape[mesh_axes(mesh).index(name)])


def _device_mesh(shape: tuple, axes: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world size must be the mesh's size.  ``device``: the card unless the
    caller passes ``"cpu"`` or ``"meta"`` (a mesh of CPU ranks then)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    world, size = dist.get_world_size(), math.prod(shape)
    if world != size:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh has {size} devices, "
                         f"the default process group {world}")
    dev = resolve_device(device)
    return init_device_mesh("cuda" if dev.type == "cuda" else "cpu", shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 ``("data", "model")``, or 2×16×16 ``("pod", "data", "model")``
    with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A small ``("data", "model")`` mesh over the default process group,
    as the tests use."""
    return _device_mesh((data, model), ("data", "model"), device)


def agent_axes(mesh, agent_axis: str):
    """Mesh axes carrying the federated agent dimension.

    agent_axis: "pod"  → agents = pods (big archs; single-pod ⇒ 1 agent)
                "data" → agents spread over data(+pod) axes (small archs)
    """
    names = mesh_axes(mesh)
    if agent_axis == "data":
        return tuple(n for n in names if n in ("pod", "data"))
    if agent_axis == "pod":
        return ("pod",) if "pod" in names else ()
    raise ValueError(agent_axis)


def n_agents(mesh, agent_axis: str) -> int:
    n = 1
    for a in agent_axes(mesh, agent_axis):
        n *= axis_size(mesh, a)
    return max(n, 1)


def destroy_process_group() -> None:
    """Destroy the default process group if there is one, so that no later
    code in the process sees a leftover group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(init_file: str, backend: str = "gloo", rank: int = 0,
                  world_size: int = 1):
    """The default process group for the ``with`` block (``backend`` over a
    ``file://`` rendezvous at ``init_file``, a path no earlier group has
    used), destroyed on leaving it."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, fn, world_size, init_file, backend, args):
    with process_group(init_file, backend, rank, world_size):
        fn(rank, world_size, *args)


def run_ranks(fn, world_size: int, init_file: str, *args, backend: str = "gloo"):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` local processes,
    each in the default process group (``backend`` over a ``file://``
    rendezvous at ``init_file``, a path no earlier run has used), which is
    destroyed when ``fn`` returns.  ``fn`` must be importable by name
    (module level); a failing rank raises here."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(fn, world_size, str(init_file), backend, args),
             nprocs=world_size, join=True)


__all__ = ["AbstractMesh", "agent_axes", "axis_size", "destroy_process_group",
           "make_host_mesh", "make_production_mesh", "mesh_axes", "n_agents",
           "process_group", "run_ranks"]
