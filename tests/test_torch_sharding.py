"""The port's launch/ sharding rules against the JAX package's.

``repro_torch.launch.sharding`` reads only axis names and sizes, so its
spec functions run on the port's ``AbstractMesh`` and the JAX package's on
``jax.sharding.AbstractMesh((16, 16), ("data", "model"))`` and
``((2, 16, 16), ("pod", "data", "model"))``, with no devices and no
compile.  Parameter trees come from both packages' ``init_params`` at full
size, shapes only (``jax.eval_shape`` and the port's meta device); every
spec is compared as a tuple, leaf by leaf in leaf order.  The layout of a
spec on a ``DeviceMesh`` is held against JAX's ``NamedSharding`` with the
other multi-rank checks in ``tests/test_torch_fleet.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.launch import mesh as jmesh
from repro.launch import sharding as js
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit_params
from repro_torch.configs import ARCHS
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as ts
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

MESHES = {"single": (JMesh((16, 16), ("data", "model")),
                     tmesh.AbstractMesh((16, 16), ("data", "model"))),
          "multi": (JMesh((2, 16, 16), ("pod", "data", "model")),
                    tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model")))}
N_STACK = 32


def _jax_specs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(values, specs):
    """The port's specs in leaf order of the value tree they describe (a
    spec is a tuple, so the walk follows the values)."""
    out = []
    tree_map(lambda _, s: out.append(tuple(s)), values, specs)
    return out


def _stack(tree_j, tree_t, n):
    sj = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape, s.dtype),
                                tree_j)
    st = tree_map(lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                        device="meta"), tree_t)
    return sj, st


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_jax_for_every_arch(arch):
    pj = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), JARCHS[arch]))
    pt = init_params(ARCHS[arch], device="meta")
    assert len(jax.tree_util.tree_leaves(pj)) == len(tree_leaves(pt))
    sj, st = _stack(pj, pt, N_STACK)
    for name, (jm, tm) in MESHES.items():
        cases = [(pj, pt, {}), (sj, st, dict(agent_axes=("data",), stacked=True)),
                 (sj, st, dict(agent_axes=("data",), stacked=True, fsdp=None)),
                 (pj, pt, dict(fsdp=None))]
        if name == "multi":
            cases += [(sj, st, dict(agent_axes=("pod",), stacked=True)),
                      (sj, st, dict(agent_axes=("pod", "data"), stacked=True, fsdp=None))]
        for vj, vt, kw in cases:
            want = _jax_specs(js.param_specs(vj, jm, **kw))
            got = _port_specs(vt, ts.param_specs(vt, tm, **kw))
            assert got == want, (name, kw)


def _batches(n):
    """Batch stand-ins of the dry-run's layouts: tokens and labels, the VLM
    layout (extra_embeds, M-RoPE positions), an agent-stacked train batch."""
    shapes = {"plain": {"tokens": (32, 4096), "labels": (32, 4096)},
              "vlm": {"tokens": (32, 3072), "extra_embeds": (32, 1024, 64),
                      "positions": (3, 32, 4096)},
              "one": {"tokens": (1, 1)},
              "stacked": {"tokens": (n, 16, 4096), "labels": (n, 16, 4096)}}
    return {k: ({a: jax.ShapeDtypeStruct(s, jnp.int32) for a, s in v.items()},
                {a: torch.empty(s, dtype=torch.int32, device="meta") for a, s in v.items()})
            for k, v in shapes.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_jax(mesh):
    jm, tm = MESHES[mesh]
    for kind, (bj, bt) in _batches(N_STACK).items():
        agent_sets = [()] if kind != "stacked" else [("data",), ("pod",), ("pod", "data")]
        for aa in agent_sets:
            if any(a not in tmesh.mesh_axes(tm) for a in aa):
                continue
            kw = dict(agent_axes=aa, stacked=kind == "stacked")
            assert (_port_specs(bt, ts.batch_specs(bt, tm, **kw))
                    == _jax_specs(js.batch_specs(bj, jm, **kw))), (kind, aa)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-20b", "zamba2-2.7b",
                                  "rwkv6-3b", "mixtral-8x7b"])
@pytest.mark.parametrize("batch,seq", [(128, 32768), (1, 524288), (4, 8192)])
def test_cache_specs_equal_jax(arch, batch, seq):
    """KV (and int8 KV), SSM and RWKV caches: batch-sharded when the batch
    divides the data axes, else the long-context sequence over "data"."""
    cfg_j, cfg_t = JARCHS[arch], ARCHS[arch]
    for kv_int8 in (False, True):
        cj = dataclasses.replace(cfg_j, kv_cache_int8=kv_int8)
        ct = dataclasses.replace(cfg_t, kv_cache_int8=kv_int8)
        cache_j = jax.eval_shape(lambda: jinit_cache(cj, batch, seq, jnp.bfloat16))
        cache_t = init_cache(ct, batch, s_max=seq, dtype=torch.bfloat16, device="meta")
        for jm, tm in MESHES.values():
            for shard_batch in (True, False):
                want = _jax_specs(js.cache_specs(cache_j, jm, shard_batch=shard_batch))
                got = []
                # the JAX cache's length is a traced int32 leaf, the port's an int
                tree_map(lambda x, s: got.append(tuple(s)), cache_t,
                         ts.cache_specs(cache_t, tm, shard_batch=shard_batch))
                assert got == want, (kv_int8, shard_batch)


def test_fleet_specs_equal_jax():
    jm = jax.make_mesh((1,), ("fleet",))
    tm = tmesh.AbstractMesh((1,), ("fleet",))
    tree_j = {"a": jnp.ones((4, 3)), "s": jnp.zeros(()), "c": jnp.ones((3,))}
    tree_t = {"a": torch.ones((4, 3)), "s": torch.zeros(()), "c": torch.ones((3,))}
    for n in (None, 4):
        assert (_port_specs(tree_t, ts.fleet_specs(tree_t, tm, n_agents=n))
                == _jax_specs(js.fleet_specs(tree_j, jm, n_agents=n)))
    tm4 = tmesh.AbstractMesh((4,), ("fleet",))
    specs = ts.fleet_specs({"a": torch.ones((8, 3)), "b": torch.ones((6,)), "k": 3}, tm4,
                           n_agents=8)
    assert specs == {"a": ts.P("fleet"), "b": ts.P(), "k": ts.P()}


def test_partition_spec_strings_are_jax_strings():
    for entries in [(), ("fleet",), (None,), (None, "data", "model"),
                    (("pod", "data"), None), ("model", ("pod", "data"))]:
        assert str(ts.P(*entries)) == str(JP(*entries)) == repr(ts.P(*entries))
        assert tuple(ts.P(*entries)) == tuple(JP(*entries))


def test_mesh_helpers_equal_jax():
    for jm, tm in MESHES.values():
        assert tmesh.mesh_axes(tm) == jmesh.mesh_axes(jm)
        for ax in ("data", "pod"):
            assert tmesh.agent_axes(tm, ax) == jmesh.agent_axes(jm, ax)
            assert tmesh.n_agents(tm, ax) == jmesh.n_agents(jm, ax)
        for name in tmesh.mesh_axes(tm):
            assert tmesh.axis_size(tm, name) == jm.shape[name]
    with pytest.raises(ValueError):
        tmesh.agent_axes(MESHES["single"][1], "model")


def test_meshes_need_a_process_group_of_their_size(tmp_path):
    """Importing builds nothing; a mesh without a default group raises, and
    so does one whose size is not the group's, with both numbers; on a
    1-rank group the host mesh is a DeviceMesh and the fleet mesh None."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_production_mesh(device="cpu")
    with tmesh.process_group(str(tmp_path / "rendezvous")):
        with pytest.raises(ValueError, match="256 devices, the default process group 1"):
            tmesh.make_production_mesh(device="cpu")
        mesh = tmesh.make_host_mesh(1, 1, device="cpu")
        assert tmesh.mesh_axes(mesh) == ("data", "model")
        assert tmesh.axis_size(mesh, "model") == 1
        assert ts.fleet_mesh(device="cpu") is None
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    tm = tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert ts.placements(ts.P(None, "data", "model"), tm) == (Replicate(), Shard(1), Shard(2))
    assert ts.placements(ts.P(("pod", "data"), None), tm) == (Shard(0), Shard(0), Replicate())
    assert ts.placements(ts.P(), tm) == (Replicate(),) * 3
    assert ts.spec_of(ts.placements(ts.P(("pod", "data"), "model"), tm), tm) == \
        ts.P(("pod", "data"), "model")
    with pytest.raises(ValueError, match="order"):
        ts.placements(ts.P(("data", "pod")), tm)
    assert ts.local_shape((64, 32, 5), tm, ts.P(("pod", "data"), "model")) == (2, 2, 5)
