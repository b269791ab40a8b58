"""The launch slice on four gloo ranks: the fleet-sharded Fed-LT round, a
sharded deploy round, a sharded restore and the layout of tuple specs.

One subprocess runs four local ranks (``torch.distributed`` with gloo, a
``file://`` rendezvous under ``tmp_path``), and beside them, in a thread of
its main process, JAX over four forced host devices: the layouts JAX's
``NamedSharding`` gives, and ``jax.jit`` of the JAX package's
``FedLT.round``.  The ranks run:

* ``FedLT.round_sharded`` over a ``("fleet",)`` mesh, fused and unfused,
  from a state laid out by ``shard_fleet``, also under a participation
  mask, and ``run(mesh=)`` for three rounds.  The states, gathered, are
  held against the port's unsharded round and ``jax.jit`` of the JAX
  package's ``FedLT.round`` on the same numpy-made data, at the JAX
  package's size (8 agents, ``tests/test_fleet_sharding.py``) and
  tolerance (atol = rtol = 1e-5): the aggregate's summation order is the
  one thing sharding changes.
* ``DeployFedLT.round_step(agent_replicate_spec=)`` on a smoke config, 4
  agents over a ``("data",)`` mesh, with and without ``pack_wire``: every
  level int the round decodes, and every state leaf, bit for bit the
  unsharded round's (each rank trains its own agents; the integer wire
  is gathered before the mean).
* ``checkpoint.store.save(specs=)`` of that sharded state, then at once
  ``restore(mesh=, specs=)``, twice to one path: each rank's shard bit
  for bit, the second save's.
* ``launch.sharding.distribute`` on a 2×2 ``("pod", "data")`` mesh: each
  rank's shard of each spec, tuple specs included, equals the slice that
  JAX's ``devices_indices_map`` gives its device.
* Tensor parallelism on a 2×2 ``("data", "model")`` mesh with the rules'
  default ``tp="model"``: a deploy round (agents over ``"data"``, weights
  over ``"model"``) on a grouped-query smoke config whose 3 KV heads do
  not split over 2 head shards; one on mixtral's smoke variant with
  capacity dispatch, the agents whole on every rank, each agent's batch
  over ``"data"`` and FSDP weights; a prefill and one decode step on the
  grouped-query config and on granite's (one KV head, tied embeddings),
  vocab and heads sharded.  The
  gathered states and logits are held against the unsharded port at
  atol = rtol = 1e-5: the row-parallel products sum in another order, and
  a wrong KV-head slice or vocab offset moves them by far more.

JAX is imported only inside the tests and in the subprocess's main: the
spawned ranks import this module and must stay light.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

ROOT = Path(__file__).resolve().parents[1]
WORLD, N, M, D = 4, 8, 20, 12
LOSS_EPS = 5.0
TUNED = dict(n_epochs=3, gamma=0.05, rho=5.0)
QUANT = dict(levels=100, vmin=-3.0, vmax=3.0, clip=True)
FIELDS = ("x", "z", "c_up", "z_hat", "c_down")
RUN_ROUNDS = 3
DEPLOY_FIELDS = ("x", "z", "c_up", "y_hat", "c_down")
DEPLOY_AGENTS, DEPLOY_SEQ = 4, 16
LAYOUT_SPECS = [("pod", "data"), ("pod",), ("data",), (None, ("pod", "data"))]
LAYOUT_SHAPE = (8, 12)
# (tag, arch, overrides): smoke configs run tensor-parallel
TP_GQA = ("gqa", "h2o-danube-3-4b", dict(n_heads=6, n_kv_heads=3))
# (tag, arch, overrides, agent axes), as the dry-run lays out each arch's
# round: agents over "data", or (a "pod" arch on a mesh with no pod axis)
# whole on every rank, each agent's batch of 2 over "data", the weights
# FSDP over "data" and the MoE dispatch tokens kept there
TP_DEPLOY = [TP_GQA + (("data",),),
             ("moe", "mixtral-8x7b", dict(moe_dispatch="capacity",
                                          act_batch_axis="data"), ())]
TP_SERVE = [TP_GQA, ("mqa", "granite-20b", {})]
TP_AGENTS = 2
# token groups of 16, so each agent's 2 x 16 tokens make 2 groups, one per
# "data" rank (the JAX package's groups of 256 would make one)
TP_MOE_GROUP = 16
SERVE_BATCH, SERVE_SEQ = 2, 16


def _data():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(N, M, D)).astype(np.float32)
    b = np.where(rng.random((N, M)) < 0.5, -1.0, 1.0).astype(np.float32)
    return {"a": a, "b": b}


def _mask():
    active = np.random.default_rng(1).random(N) < 0.6
    active[0] = True
    return active


def _port_alg(fused):
    from repro_torch.core import compression as tc
    from repro_torch.core import error_feedback as te
    from repro_torch.core import fedlt as tf
    from repro_torch.data import logistic as tl
    q = tc.UniformQuantizer(**QUANT)
    return tf.FedLT(loss=tl.make_local_loss(LOSS_EPS, N), uplink=te.EFChannel(q),
                    downlink=te.EFChannel(q), fused_uplink=fused, **TUNED)


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _gathered(state, fields):
    from repro_torch.core.pytree import tree_leaves
    return {f"{f}{i}": _whole(t).float().numpy()
            for f in fields for i, t in enumerate(tree_leaves(getattr(state, f)))}


# -- the deploy round (smoke config), run in the ranks and here --------------

def _smoke_cfg(arch="stablelm-1.6b", **overrides):
    from repro_torch.configs import ARCHS, smoke_variant
    return dataclasses.replace(smoke_variant(ARCHS[arch]), dtype="float32", **overrides)


def _deploy_setup(pack, cfg=None, n_agents=DEPLOY_AGENTS, per_agent=1):
    from repro_torch.core.deploy import DeployFedLT
    cfg = cfg or _smoke_cfg()
    alg = DeployFedLT(cfg, n_epochs=1, pack_wire=pack, levels=255, vmin=-0.5, vmax=0.5)
    state = alg.init(n_agents, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (n_agents, per_agent, DEPLOY_SEQ))
    toks = torch.from_numpy(toks.astype(np.int64))
    return alg, state, {"tokens": toks, "labels": toks}


def _decoded_ints(monkeypatch_target, record):
    """Wrap ``core.deploy.quantize_decode`` so the level ints of every
    leaf's uplink wire, as the coordinator decodes them (all agents, after
    the gather), are recorded; returns the undo.  Those decodes name a
    dtype and carry the agent dim; the EF cache's own decode names none."""
    orig = monkeypatch_target.quantize_decode

    def spy(idx, *a, **kw):
        if "dtype" in kw and idx.shape[0] == DEPLOY_AGENTS:
            record.append(idx.to(torch.int64).numpy().copy())
        return orig(idx, *a, **kw)

    monkeypatch_target.quantize_decode = spy
    return lambda: setattr(monkeypatch_target, "quantize_decode", orig)


def _tp_sizes(cfg, agents):
    """(agents, batch per agent) of a deploy round: the tensor-parallel
    rounds take fewer agents, and with the agents whole a batch of 2."""
    return (DEPLOY_AGENTS, 1) if cfg is None else (TP_AGENTS, 1 if agents else 2)


def _deploy_sharded(mesh, pack, out, cfg=None, tag=None, agents=("data",)):
    """One deploy round over ``mesh``, agents on ``agents``; with ``cfg``
    the weights also take the rules' default tensor parallelism over
    ``"model"``, and with no agent axis FSDP over ``"data"``."""
    from repro_torch.core import deploy
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.sharding import P, batch_specs, distribute, param_specs

    alg, state, batch = _deploy_setup(pack, cfg, *_tp_sizes(cfg, agents))
    tp = {} if cfg is not None else {"tp": None}
    ps_a = param_specs(state.x, mesh, agent_axes=agents, stacked=True,
                       fsdp=None if agents else "data", **tp)
    ps_c = param_specs(state.y_hat, mesh, agent_axes=(), **tp)
    place = lambda tree, specs: tree_map(lambda x, s: distribute(x, mesh, s), tree, specs)
    sharded = deploy.DeployState(x=place(state.x, ps_a), z=place(state.z, ps_a),
                                 c_up=place(state.c_up, ps_a),
                                 y_hat=place(state.y_hat, ps_c),
                                 c_down=place(state.c_down, ps_c), k=0)
    b_specs = batch_specs(batch, mesh, agent_axes=agents, stacked=True)
    rep = tree_map(lambda _, s: P(None, *tuple(s)[1:]), state.x, ps_a)
    ints = []
    undo = _decoded_ints(deploy, ints)
    try:
        new, metrics = alg.round_step(sharded, place(batch, b_specs),
                                      agent_replicate_spec=rep)
    finally:
        undo()
    tag = tag or f"deploy{int(pack)}"
    out.update({f"{tag}.{k}": v for k, v in _gathered(new, DEPLOY_FIELDS).items()})
    if cfg is None:     # tensor-parallel ranks decode only their weight shards
        out.update({f"{tag}.ints{i}": v for i, v in enumerate(ints)})
    out[f"{tag}.loss"] = np.float64(metrics["loss"])
    return new, deploy.DeployState(x=ps_a, z=ps_a, c_up=ps_a, y_hat=ps_c, c_down=ps_c,
                                   k=P())


def _serve_setup(cfg):
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ))
    return params, {"tokens": torch.from_numpy(toks.astype(np.int64))}


def _serve(cfg, params, batch, place=lambda t: t):
    """Prefill, then one decode step on the prefill's greedy tokens: (the
    two logits, gathered)."""
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    logits, cache = make_prefill_step(cfg)(params, batch)
    tok = place(_whole(logits).argmax(-1, keepdim=True))
    logits2, _ = make_decode_step(cfg)(params, cache, tok)
    return _whole(logits).numpy(), _whole(logits2).numpy()


def _serve_sharded(mesh, cfg, out, tag):
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.sharding import batch_specs, distribute, param_specs

    params, batch = _serve_setup(cfg)
    params = tree_map(lambda x, s: distribute(x, mesh, s), params,
                      param_specs(params, mesh, agent_axes=()))
    b_spec = batch_specs(batch, mesh, agent_axes=())["tokens"]
    place = lambda t: distribute(t, mesh, b_spec)
    out[f"{tag}.prefill"], out[f"{tag}.decode"] = _serve(
        cfg, params, {"tokens": place(batch["tokens"])}, place)


def _worker(rank, world, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import store
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.launch.sharding import (P, constrain, distribute, fleet_mesh,
                                             shard_fleet)

    torch.set_num_threads(1)     # four ranks beside the other test workers
    out = {}
    # -- the fleet-sharded Fed-LT round ------------------------------------
    mesh = fleet_mesh(device="cpu")
    assert mesh is not None and mesh.size() == world
    data = {k: torch.from_numpy(v) for k, v in _data().items()}
    cases = [("fused", True, np.ones(N, bool)), ("unfused", False, np.ones(N, bool)),
             ("masked", True, _mask())]
    for name, fused, active in cases:
        alg = _port_alg(fused)
        state = alg.init(torch.zeros(D), N)
        want, info_u = alg.round(state, data, torch.from_numpy(active))
        got, info = alg.round_sharded(mesh, N)(
            shard_fleet(state, mesh, n_agents=N), shard_fleet(data, mesh, n_agents=N),
            torch.from_numpy(active))
        assert int(info["n_active"]) == int(info_u["n_active"]) == active.sum()
        assert got.k == 1
        out.update({f"{name}.sharded.{k}": v for k, v in _gathered(got, FIELDS).items()})
        out.update({f"{name}.plain.{k}": v for k, v in _gathered(want, FIELDS).items()})
    alg = _port_alg(True)
    state = alg.init(torch.zeros(D), N)
    masks = torch.from_numpy(np.stack([_mask()] * RUN_ROUNDS))
    got, infos = alg.run(shard_fleet(state, mesh, n_agents=N),
                         shard_fleet(data, mesh, n_agents=N), RUN_ROUNDS,
                         active=masks, mesh=mesh)
    want, infos_u = alg.run(state, data, RUN_ROUNDS, active=masks)
    assert got.k == RUN_ROUNDS and torch.equal(infos["n_active"], infos_u["n_active"])
    out.update({f"run.sharded.{k}": v for k, v in _gathered(got, FIELDS).items()})
    out.update({f"run.plain.{k}": v for k, v in _gathered(want, FIELDS).items()})

    # -- the sharded deploy round, then its checkpoint ---------------------
    dmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    unpacked, _ = _deploy_sharded(dmesh, False, out)
    new, specs = _deploy_sharded(dmesh, True, out)
    path = os.path.join(out_dir, "ckpt", "state")
    like = tree_map(lambda t: _whole(t) if isinstance(t, torch.Tensor) else t, new)
    # each rank restores as soon as save returns: the first save's files
    # must be there, and the second's must have replaced them
    for saved in (new, unpacked):
        store.save(path, saved, specs=specs, step=1)      # every rank: a gather
        back = store.restore(path, like, mesh=dmesh, specs=specs)
        for a, b in zip(tree_leaves(tuple(saved)[:5]), tree_leaves(tuple(back)[:5])):
            assert a.placements == b.placements
            assert torch.equal(a.to_local(), b.to_local())
        assert back.k == saved.k == 1

    # -- a spec's shard on a 2x2 ("pod", "data") mesh ------------------------
    lmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    full = torch.arange(int(np.prod(LAYOUT_SHAPE)), dtype=torch.float32)
    full = full.reshape(LAYOUT_SHAPE)
    layout = {}
    for i, spec in enumerate(LAYOUT_SPECS):
        d = distribute(full, lmesh, P(*spec))
        assert torch.equal(d.full_tensor(), full)
        assert torch.equal(constrain(d, P()).to_local(), full)
        layout[str(i)] = d.to_local().reshape(-1).tolist()
    with open(os.path.join(out_dir, f"layout{rank}.json"), "w") as f:
        json.dump(layout, f)

    # -- tensor parallelism on a 2x2 ("data", "model") mesh ------------------
    from repro_torch.models import moe
    moe.MOE_GROUP = TP_MOE_GROUP
    tmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for tag, arch, over, agents in TP_DEPLOY:
        _deploy_sharded(tmesh, True, out, _smoke_cfg(arch, **over), f"tp.{tag}", agents)
    for tag, arch, over in TP_SERVE:
        _serve_sharded(tmesh, _smoke_cfg(arch, **over), out, f"serve.{tag}")
    if rank == 0:
        np.savez(os.path.join(out_dir, "ranks.npz"), **out)


def _jax_layouts(out_dir):
    """Each device's slice of LAYOUT_SHAPE under each spec, by JAX's
    ``NamedSharding`` over a 2×2 mesh of the four forced host devices
    (rank r ↔ mesh position (r // 2, r % 2), as a ``DeviceMesh``)."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    assert len(jax.devices()) == 4
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("pod", "data"))
    full = np.arange(int(np.prod(LAYOUT_SHAPE)), dtype=np.float32).reshape(LAYOUT_SHAPE)
    out = {}
    for i, spec in enumerate(LAYOUT_SPECS):
        where = NamedSharding(mesh, JP(*spec)).devices_indices_map(LAYOUT_SHAPE)
        out[str(i)] = [full[where[mesh.devices[r // 2, r % 2]]].reshape(-1).tolist()
                       for r in range(4)]
    with open(os.path.join(out_dir, "layout_jax.json"), "w") as f:
        json.dump(out, f)


def _jax_rounds(out_dir):
    """``jax.jit`` of the JAX package's ``FedLT.round`` on the same data, for
    each case of the sharded round (one compile per uplink route)."""
    import jax
    import jax.numpy as jnp

    from repro.core import compression as jc
    from repro.core import error_feedback as je
    from repro.core import fedlt as jf
    from repro.data import logistic as jl

    q = jc.UniformQuantizer(**QUANT)
    data = {k: jnp.asarray(v) for k, v in _data().items()}
    out = {}
    for fused in (True, False):
        alg = jf.FedLT(loss=jl.make_local_loss(LOSS_EPS, N), uplink=je.EFChannel(q),
                       downlink=je.EFChannel(q), fused_uplink=fused, **TUNED)
        round_fn = jax.jit(alg.round)
        for case in (("fused", "masked") if fused else ("unfused",)):
            active = _mask() if case == "masked" else np.ones(N, bool)
            state, _ = round_fn(alg.init(jnp.zeros(D), N), data, jnp.asarray(active),
                                jax.random.PRNGKey(7))
            out.update({f"jax.{case}.{f}": np.asarray(getattr(state, f)) for f in FIELDS})
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get(
                   "PYTHONPATH", "")]).rstrip(os.pathsep))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ranks.npz") as f, np.load(out / "jax.npz") as g:
        return out, {**f, **g}


@pytest.mark.parametrize("case", ["fused", "unfused", "masked", "run"])
def test_sharded_round_matches_unsharded(ranks, case):
    _, res = ranks
    keys = [k[len(f"{case}.plain."):] for k in res if k.startswith(f"{case}.plain.")]
    assert len(keys) == len(FIELDS)
    for k in keys:
        np.testing.assert_allclose(res[f"{case}.sharded.{k}"], res[f"{case}.plain.{k}"],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["fused", "unfused", "masked"])
def test_sharded_round_matches_jax(ranks, case):
    _, res = ranks
    for f in FIELDS:
        np.testing.assert_allclose(res[f"{case}.sharded.{f}0"], res[f"jax.{case}.{f}"],
                                   atol=1e-5, rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("pack", [False, True])
def test_sharded_deploy_round_is_the_unsharded_round(ranks, pack):
    """Level ints and every state leaf bit for bit, the loss equal."""
    from repro_torch.core import deploy

    _, res = ranks
    alg, state, batch = _deploy_setup(pack)
    ints = []
    undo = _decoded_ints(deploy, ints)
    try:
        new, metrics = alg.round_step(state, batch)
    finally:
        undo()
    tag = f"deploy{int(pack)}"
    got = [res[k] for k in sorted((k for k in res if k.startswith(f"{tag}.ints")),
                                  key=lambda k: int(k[len(f"{tag}.ints"):]))]
    assert len(got) == len(ints) > 0
    for a, b in zip(got, ints):
        np.testing.assert_array_equal(a, b)
    for k, v in _gathered(new, DEPLOY_FIELDS).items():
        np.testing.assert_array_equal(res[f"{tag}.{k}"], v, err_msg=k)
    assert float(res[f"{tag}.loss"]) == float(metrics["loss"])


@pytest.mark.parametrize("case", [t[0] for t in TP_DEPLOY])
def test_tensor_parallel_deploy_round_matches_unsharded(ranks, case, monkeypatch):
    from repro_torch.models import moe

    _, res = ranks
    monkeypatch.setattr(moe, "MOE_GROUP", TP_MOE_GROUP)
    _, arch, over, agents = next(t for t in TP_DEPLOY if t[0] == case)
    cfg = _smoke_cfg(arch, **over)
    alg, state, batch = _deploy_setup(True, cfg, *_tp_sizes(cfg, agents))
    new, metrics = alg.round_step(state, batch)
    for k, v in _gathered(new, DEPLOY_FIELDS).items():
        np.testing.assert_allclose(res[f"tp.{case}.{k}"], v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(res[f"tp.{case}.loss"]), float(metrics["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("case", [t[0] for t in TP_SERVE])
def test_tensor_parallel_serving_matches_unsharded(ranks, case):
    _, res = ranks
    _, arch, over = next(t for t in TP_SERVE if t[0] == case)
    cfg = _smoke_cfg(arch, **over)
    assert cfg.n_kv_heads < cfg.n_heads
    prefill, decode = _serve(cfg, *_serve_setup(cfg))
    np.testing.assert_allclose(res[f"serve.{case}.prefill"], prefill, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(res[f"serve.{case}.decode"], decode, atol=1e-5, rtol=1e-5)


def test_tuple_spec_layout_matches_jax_named_sharding(ranks):
    out, _ = ranks
    want = json.loads((out / "layout_jax.json").read_text())
    for r in range(WORLD):
        got = json.loads((out / f"layout{r}.json").read_text())
        for i, spec in enumerate(LAYOUT_SPECS):
            assert got[str(i)] == want[str(i)][r], (spec, r)


def test_fleet_mesh_single_device_is_none():
    from repro_torch.launch.sharding import fleet_mesh, shard_fleet
    assert fleet_mesh() is None                 # no process group here
    tree = {"a": torch.ones((4, 3))}
    assert shard_fleet(tree, None) is tree


def test_round_sharded_rejects_an_indivisible_fleet():
    from repro_torch.launch.mesh import AbstractMesh
    with pytest.raises(ValueError, match="not divisible"):
        _port_alg(True).round_sharded(AbstractMesh((3,), ("fleet",)), N)


def _jax_side(out_dir):
    _jax_layouts(out_dir)
    _jax_rounds(out_dir)


if __name__ == "__main__":
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import run_ranks
    with ThreadPoolExecutor(1) as pool:     # JAX runs beside the ranks
        jax_done = pool.submit(_jax_side, sys.argv[1])
        run_ranks(_worker, WORLD, os.path.join(sys.argv[1], "rendezvous"), sys.argv[1])
        jax_done.result()
