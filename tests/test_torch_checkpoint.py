"""Checkpoints and resume in the port (``repro_torch.checkpoint``) against
the JAX package's ``repro.checkpoint``.

Every state is built from numpy draws of one seed and handed to both
packages.  A checkpoint saved by either package restores in the other
with equal leaves (exact: the files hold the same float32 / int32 bytes)
and the same ``meta["names"]``, which are ``jax.tree_util.keystr`` of
each leaf's path.  A run resumed through ``Experiment`` ends bit for bit
equal to the uninterrupted run (``torch.equal`` on every leaf, the
RoundLogs equal), with a quantizer on the fused uplink and with RandD on
the batched path.  A round-k checkpoint written by the JAX package and
resumed in the port continues within rtol 1e-5 / atol 1e-6 of JAX's own
continuation (``x``, ``z``): float32 sums run in another order than
XLA's over the continued rounds.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro import api as japi
from repro.checkpoint import run as jrun
from repro.checkpoint import store as jstore
from repro.core import compression as jc
from repro.core import error_feedback as je
from repro.core import fedlt as jf
from repro.data import logistic as jl
from repro_torch import api as tapi
from repro_torch import channel as tch
from repro_torch import convert
from repro_torch.bench import common as tcommon
from repro_torch.checkpoint import run as trun
from repro_torch.checkpoint import store as tstore
from repro_torch.core import compression as tc
from repro_torch.core import error_feedback as te
from repro_torch.core import fedlt as tf
from repro_torch.core.pytree import (tree_flatten_with_names, tree_leaves,
                                     tree_unflatten)
from repro_torch.data import logistic as tl

N, M, D = 100, 16, 8
R = 4                                  # resume at round R of 2R
TUNED = dict(n_epochs=10, gamma=0.005, rho=20.0)
QUANT = dict(levels=10, vmin=-1.0, vmax=1.0, clip=True)
MODEL = {"w": np.zeros(D, np.float32), "b": np.zeros(1, np.float32)}
ALGOS = ("fedlt", "fedavg", "led", "5gcs")   # FedState's extra: (), ψ, (h,)


def _states(algo, seed=0):
    """The same state of ``algo`` in both packages: ``init`` on the dict
    model, every leaf then drawn from numpy, k = 3."""
    rng = np.random.default_rng(seed)
    if algo == "fedlt":
        js = jf.FedLT(loss=None).init(jax.tree_util.tree_map(jnp.asarray, MODEL), 5)
        ts = tf.FedLT(loss=None).init(
            {k: torch.from_numpy(v) for k, v in MODEL.items()}, 5)
    else:
        q = jcommon.COMPRESSORS["quant_coarse"]
        js = jcommon.make_algorithm(algo, None, q).init(
            jax.tree_util.tree_map(jnp.asarray, MODEL), 5)
        ts = tcommon.make_algorithm(algo, None, tcommon.COMPRESSORS["quant_coarse"]).init(
            {k: torch.from_numpy(v) for k, v in MODEL.items()}, 5)
    leaves = [rng.standard_normal(np.shape(x)).astype(np.float32)
              for x in jax.tree_util.tree_leaves(js)[:-1]]
    js = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(js),
                                      [jnp.asarray(a) for a in leaves]
                                      + [jnp.int32(3)])
    ts = tree_unflatten(ts, [torch.from_numpy(a.copy()) for a in leaves] + [3])
    return js, ts


def _keystr_names(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in flat]


def _assert_same_leaves(t_tree, j_tree):
    tl_, jl_ = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(tl_) == len(jl_)
    for a, b in zip(tl_, jl_):
        if isinstance(a, int):
            assert a == int(b) and np.asarray(b).dtype == np.int32
        else:
            assert a.dtype == convert._tensor(np.asarray(b), "cpu").dtype
            np.testing.assert_array_equal(convert._array(a), np.asarray(b))


@pytest.mark.parametrize("algo", ALGOS)
def test_names_are_jax_keystr(algo):
    js, ts = _states(algo)
    names, leaves = tree_flatten_with_names(ts)
    assert names == _keystr_names(js)
    assert names[-1] == ".k" and leaves[-1] == 3
    if algo == "5gcs":
        assert ".extra[0]['b']" in names
    if algo == "fedavg":
        assert not any(n.startswith(".extra") for n in names)   # () has no leaf
    assert tree_flatten_with_names(torch.zeros(2))[0] == [""]


@pytest.mark.parametrize("algo", ALGOS)
def test_repro_checkpoint_restores_in_the_port(algo, tmp_path):
    js, ts = _states(algo)
    path = str(tmp_path / "ck")
    jstore.save(path, js, step=7, extra={"t": 1.5})
    like = tree_unflatten(ts, [torch.zeros_like(x) if torch.is_tensor(x) else 0
                               for x in tree_leaves(ts)])
    out = tstore.restore(path, like)
    assert type(out) is type(ts) and isinstance(out.k, int)
    _assert_same_leaves(out, js)
    assert tstore.verify(path) and tstore.load_meta(path)["extra"] == {"t": 1.5}


@pytest.mark.parametrize("algo", ALGOS)
def test_port_checkpoint_restores_in_repro(algo, tmp_path):
    js, ts = _states(algo)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    tstore.save(ours, ts, step=7, extra={"t": 1.5})
    jstore.save(theirs, js, step=7, extra={"t": 1.5})
    like = jax.tree_util.tree_map(jnp.zeros_like, js)
    _assert_same_leaves(ts, jstore.restore(ours, like))
    m_ours, m_theirs = tstore.load_meta(ours), jstore.load_meta(theirs)
    assert m_ours["names"] == m_theirs["names"]
    assert m_ours["dtypes"] == m_theirs["dtypes"]
    assert m_ours["dtypes"][-1] == "int32"
    assert {k: v for k, v in m_ours.items() if k != "checksum"} == \
        {k: v for k, v in m_theirs.items() if k != "checksum"}
    assert jstore.verify(ours)


def test_bf16_leaf_round_trips(tmp_path):
    vals = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    j_tree = {"w": jnp.asarray(vals, jnp.bfloat16), "n": jnp.arange(4, dtype=jnp.int32)}
    t_tree = {"w": torch.from_numpy(vals).to(torch.bfloat16),
              "n": torch.arange(4, dtype=torch.int32)}
    jstore.save(str(tmp_path / "j"), j_tree)
    tstore.save(str(tmp_path / "t"), t_tree)
    for path in ("j", "t"):
        meta = tstore.load_meta(str(tmp_path / path))
        assert meta["dtypes"] == ["int32", "bfloat16"] and meta["names"] == ["['n']", "['w']"]
        with np.load(str(tmp_path / path) + ".npz") as f:
            assert f["a1"].dtype == np.float32           # stored as float32
        out = tstore.restore(str(tmp_path / path), t_tree)
        assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], t_tree["w"])
        back = jstore.restore(str(tmp_path / path), j_tree)
        assert back["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                      np.asarray(j_tree["w"], np.float32))


def test_checksum_and_shape_mismatch_raise(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32)}
    good, bad = str(tmp_path / "ck_000001"), str(tmp_path / "ck_000002")
    tstore.save(good, tree, step=1)
    tstore.save(bad, tree, step=2)
    assert tstore.verify(good) and tstore.verify(bad)
    with open(bad + ".npz", "r+b") as f:          # flip bytes mid-file
        f.seek(30)
        f.write(b"\xde\xad\xbe\xef")
    assert not tstore.verify(bad) and not jstore.verify(bad)
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        tstore.restore(bad, tree)
    with pytest.raises(ValueError, match=r"shape mismatch for \['a'\]"):
        tstore.restore(good, {"a": torch.zeros(5)})
    assert tstore.latest_valid_step(str(tmp_path), prefix="ck_") == 1
    assert tstore.latest_step(str(tmp_path)) == 2
    assert torch.equal(tstore.restore(good, tree)["a"], tree["a"])


def test_latest_valid_step_skips_truncated_and_missing(tmp_path):
    tree = {"a": torch.zeros(4)}
    for step in (3, 5, 7):
        tstore.save(str(tmp_path / f"r_{step:06d}"), tree, step=step)
    with open(str(tmp_path / "r_000007.npz"), "r+b") as f:
        f.truncate(40)                            # a writer killed mid-save
    os.remove(str(tmp_path / "r_000005.meta.json"))
    (tmp_path / "r_000009.meta.json").write_text("{not json")
    for store in (tstore, jstore):
        assert store.latest_valid_step(str(tmp_path), prefix="r_") == 3
    assert tstore.latest_valid_step(str(tmp_path / "absent")) is None


def test_keep_last_prunes_and_load_skips_corrupt(tmp_path):
    ck = trun.RunCheckpoint(str(tmp_path), keep_last=2)
    state = {"a": torch.arange(3.0)}
    for step in range(1, 5):
        ck.save_round({"a": state["a"] + step}, step=step, t=10.0 * step,
                      up_bytes=1.0, isl_bytes=0.0, logs=[])
    assert sorted(os.listdir(tmp_path)) == [
        "round_000003.meta.json", "round_000003.npz",
        "round_000004.meta.json", "round_000004.npz"]
    with open(str(tmp_path / "round_000004.npz"), "r+b") as f:
        f.truncate(50)
    out, meta = ck.load(like=state)
    assert meta["k_next"] == 3 and meta["t"] == 30.0
    assert torch.equal(out["a"], state["a"] + 3)
    # the JAX package's RunCheckpoint reads the port's directory
    j_out, j_meta = jrun.RunCheckpoint(str(tmp_path)).load(
        like={"a": jnp.zeros(3)})
    assert j_meta == meta
    np.testing.assert_array_equal(np.asarray(j_out["a"]), [3.0, 4.0, 5.0])
    assert trun.RunCheckpoint(str(tmp_path / "none")).load(like=state) is None


def test_sharded_checkpoints_are_not_ported(tmp_path):
    """Sharded checkpoints (ported): a Fed-LT state laid out on a 1-rank
    gloo fleet mesh saves with its specs and restores onto the mesh under
    them bit for bit; the file is the unsharded one, which the JAX package
    restores; ``mesh=`` without ``specs=`` restores plain tensors, as in
    JAX."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import process_group
    from repro_torch.launch.sharding import fleet_specs, shard_fleet

    js, ts = _states("fedlt")
    with process_group(str(tmp_path / "rendezvous")):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("fleet",))
        specs = fleet_specs(ts, mesh, n_agents=5)
        sharded = shard_fleet(ts, mesh, n_agents=5)
        tstore.save(str(tmp_path / "s"), sharded, specs=specs, step=1)
        back = tstore.restore(str(tmp_path / "s"), ts, mesh=mesh, specs=specs)
        for a, b in zip(tree_leaves(ts)[:-1], tree_leaves(back)[:-1]):
            assert isinstance(b, DTensor) and torch.equal(a, b.full_tensor())
        assert back.k == 3
        assert tree_leaves(back.x)[0].placements == tree_leaves(sharded.x)[0].placements
        plain = tstore.restore(str(tmp_path / "s"), ts, mesh=mesh)
        assert not isinstance(tree_leaves(plain)[0], DTensor)
    got = jstore.restore(str(tmp_path / "s"), js)
    for a, b in zip(jax.tree_util.tree_leaves(js), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    meta = tstore.load_meta(str(tmp_path / "s"))
    assert meta["specs"] == {"": str(specs)}


def _spec_trees():
    """The same spec trees in both packages: a dict of specs (tuple axes
    included), and the NamedTuple of a deploy state's specs, which both
    packages record whole, as one string (JAX sees a node with ``index``
    as a leaf)."""
    from jax.sharding import PartitionSpec as JP

    from repro.core.deploy import DeployState as JDeployState
    from repro_torch.core.deploy import DeployState as TDeployState
    from repro_torch.launch.sharding import P

    def both(**entries):
        return ({k: JP(*v) for k, v in entries.items()},
                {k: P(*v) for k, v in entries.items()})

    dj, dt = both(embed=("model", "data"), norm=(None,), up=(None, "data", "model"),
                  stacked=(("pod", "data"), None), k=())
    nested_j, nested_t = {"x": dj, "k": JP()}, {"x": dt, "k": P()}
    return [(dj, dt), (nested_j, nested_t),
            (JDeployState(x=dj, z=dj, c_up=dj, y_hat=dj, c_down=dj, k=JP()),
             TDeployState(x=dt, z=dt, c_up=dt, y_hat=dt, c_down=dt, k=P()))]


@pytest.mark.parametrize("case", range(3))
def test_spec_strings_equal_jax(case, tmp_path):
    """``meta["specs"]`` as the port writes it equals the JAX package's for
    the same specs, name for name and string for string."""
    spec_j, spec_t = _spec_trees()[case]
    jstore.save(str(tmp_path / "j"), {"a": jnp.zeros(2)}, specs=spec_j)
    tstore.save(str(tmp_path / "t"), {"a": torch.zeros(2)}, specs=spec_t)
    want = jstore.load_meta(str(tmp_path / "j"))["specs"]
    assert tstore.load_meta(str(tmp_path / "t"))["specs"] == want
    assert tstore.spec_strings(spec_t) == want


# -- resume through Experiment ------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    """The logistic problem from numpy draws: float32 features, ±1 labels,
    in both packages, and each package's own x̄."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((N, M, D)).astype(np.float32)
    b = np.sign(a @ rng.standard_normal(D).astype(np.float32)).astype(np.float32)
    data_np = {"a": a, "b": b}
    data_t = convert.data_from_numpy(data_np, device="cpu")
    data_j = {k: jnp.asarray(v) for k, v in data_np.items()}
    return data_j, jl.solve_global(data_j), data_t, tl.solve_global(data_t)


def _port_exp(kind):
    if kind == "quant":
        q = tc.UniformQuantizer(**QUANT)
        alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(q),
                       downlink=te.EFChannel(q), fused_uplink=True, **TUNED)
        return tapi.Experiment("walker-kiruna", alg, compressor=q,
                               measure="cohort", device="cpu")
    # RandD on the batched chain, over a channel that loses 30% of the
    # uplinks (one segment, no retransmission), so the EF revert runs
    c = tc.RandD(fraction=0.2)
    alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(c),
                   downlink=te.EFChannel(c), **TUNED)
    ch = tch.ChannelModel(loss=0.3, arq=tch.SelectiveRepeatARQ(seg_bytes=4096,
                                                               max_rounds=1))
    return tapi.Experiment("lossy-uplink", alg, compressor=c, channel=ch,
                           device="cpu")


def _port_run(problem, kind, rounds, **kw):
    _, _, data_t, xbar_t = problem
    exp = _port_exp(kind)
    return exp.run(exp.init(torch.zeros(D), N), data_t, rounds, 5, log_every=1,
                   error_fn=lambda s: float(tf.optimality_error(s.x, xbar_t)), **kw)


def _assert_bit_equal(a, b):
    assert type(a.state) is type(b.state) and a.state.k == b.state.k
    for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert x == y if isinstance(x, int) else torch.equal(x, y)
    assert [dataclasses.asdict(lg) for lg in a.logs] == \
        [dataclasses.asdict(lg) for lg in b.logs]


@pytest.mark.parametrize("kind", ["quant", "randd"])
def test_resume_is_bit_for_bit(problem, kind, tmp_path):
    full = _port_run(problem, kind, 2 * R, checkpoint=str(tmp_path / "full"))
    assert full.state.k == 2 * R and len(full.logs) == 2 * R
    ck = str(tmp_path / "ck")
    first = _port_run(problem, kind, R, checkpoint=ck)
    assert first.logs == full.logs[:R]      # round k's draws do not depend on n
    resumed = _port_run(problem, kind, 2 * R, checkpoint=ck, resume=True)
    _assert_bit_equal(resumed, full)
    # the newest round torn mid-write: resume falls back one round
    with open(os.path.join(ck, f"round_{2 * R:06d}.npz"), "r+b") as f:
        f.truncate(64)
    again = _port_run(problem, kind, 2 * R, checkpoint=ck, resume=True,
                      trace=True)
    _assert_bit_equal(again, full)
    resume = [r for r in again.records if r.get("kind") == "resume"]
    assert len(resume) == 1 and resume[0]["k_next"] == 2 * R - 1
    ek = [r for r in again.records if r.get("kind") == "series"
          and r.get("name") == "e_K"]
    assert [r["step"] for r in ek] == list(range(2 * R))
    assert [r["value"] for r in ek] == [lg.error for lg in full.logs]
    if kind == "randd":
        assert sum(lg.n_lost for lg in full.logs) > 0


def test_resume_options_rejected(problem, tmp_path):
    _, _, data_t, _ = problem
    exp = _port_exp("quant")
    st = exp.init(torch.zeros(D), N)
    with pytest.raises(ValueError, match="checkpoint"):
        exp.run(st, data_t, 2, 1, resume=True)
    q = tc.UniformQuantizer(**QUANT)
    alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(q),
                   downlink=te.EFChannel(q), **TUNED)
    exp = tapi.Experiment("dual-station", alg, compressor=q, mode="async",
                          device="cpu")
    with pytest.raises(ValueError, match="sync-only"):
        exp.run(exp.init(torch.zeros(D), N), data_t, 2, 1,
                checkpoint=str(tmp_path / "a"))


def test_jax_checkpoint_resumes_in_the_port(problem, tmp_path):
    data_j, xbar_j, data_t, xbar_t = problem

    def jax_exp():
        q = jc.UniformQuantizer(**QUANT)
        alg = jf.FedLT(loss=jl.make_local_loss(50.0, N), uplink=je.EFChannel(q),
                       downlink=je.EFChannel(q), **TUNED)
        return japi.Experiment("walker-kiruna", alg, compressor=q,
                               measure="cohort")

    def jax_run(exp, rounds, ck, **kw):
        return exp.run(exp.init(jnp.zeros(D), N), data_j, rounds,
                       jax.random.PRNGKey(5), log_every=1, checkpoint=ck,
                       error_fn=lambda s: jf.optimality_error(s.x, xbar_j), **kw)

    ck_j, ck_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_run(jax_exp(), R, ck_j)
    shutil.copytree(ck_j, ck_t)
    theirs = jax_run(jax_exp(), 2 * R, ck_j, resume=True)

    q = tc.UniformQuantizer(**QUANT)
    alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(q),
                   downlink=te.EFChannel(q), **TUNED)
    exp = tapi.Experiment("walker-kiruna", alg, compressor=q, measure="cohort",
                          device="cpu")
    ours = exp.run(exp.init(torch.zeros(D), N), data_t, 2 * R, 5, log_every=1,
                   checkpoint=ck_t, resume=True,
                   error_fn=lambda s: float(tf.optimality_error(s.x, xbar_t)))
    assert ours.state.k == int(theirs.state.k) == 2 * R
    for f in ("x", "z"):
        np.testing.assert_allclose(getattr(ours.state, f).numpy(),
                                   np.asarray(getattr(theirs.state, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert ours.logs[:R] == [tapi.RoundLog(**dataclasses.asdict(lg))
                             for lg in theirs.logs[:R]]
    for a, b in zip(ours.logs, theirs.logs):
        assert (a.round, a.time, a.bytes_up, a.n_active) == \
            (b.round, b.time, b.bytes_up, b.n_active)
        np.testing.assert_allclose(a.error, b.error, rtol=1e-5)
    # the port's own checkpoints of the continued rounds read back in JAX
    meta = json.loads(open(os.path.join(ck_t, f"round_{2 * R:06d}.meta.json")).read())
    assert meta["extra"]["k_next"] == 2 * R and meta["names"][-1] == ".k"
    jstate = jstore.restore(os.path.join(ck_t, f"round_{2 * R:06d}"),
                            jax_exp().init(jnp.zeros(D), N))
    np.testing.assert_array_equal(np.asarray(jstate.x), ours.state.x.numpy())
