"""Fed-LT Algorithm 2, the slice as a whole: the port against the JAX package.

Data come from ``repro.data.logistic.generate(PRNGKey(0), n_agents=8,
m=16, dim=8)`` and are carried over with ``repro_torch.convert``; both
packages get the same per-round active masks (numpy, some agents
inactive) and run 5 rounds of ``FedLT.round`` with the paper's coarse
quantizer (L=10, ±1, clip) in both directions.  The JAX round is compiled
with ``jax.jit``, as ``FedLT.run`` compiles it.

Tolerances, each with its reason:

* ``x``, ``z``, ``c_up``, ``c_down``: allclose at rtol 1e-5, atol 1e-6.  The
  local gradient's matrix products and the mean over agents sum in
  another order than XLA's, and XLA contracts some multiply-adds of the
  local step that PyTorch rounds twice; ``c_up`` and ``c_down`` carry
  those differences of their inputs.
* ``z_hat``, the quantized uplink: bit for bit, except that in a round at
  most one entry may differ by exactly one level Δ, where ``z`` sits
  within float error of a half-level boundary.
* the uplink step itself, given the same inputs: bit for bit.
* ``solve_global``: within 1e-5 (Newton in float32, LAPACK solves).
* ``e_K``: rtol 1e-4 in every round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.core import error_feedback as je
from repro.core import fedlt as jf
from repro.data import logistic as jl
from repro_torch import convert
from repro_torch.core import compression as tc
from repro_torch.core import error_feedback as te
from repro_torch.core import fedlt as tf
from repro_torch.data import logistic as tl
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

N, M, D = 8, 16, 8
TUNED = dict(n_epochs=10, gamma=0.005, rho=20.0)
QUANT = dict(levels=10, vmin=-1.0, vmax=1.0, clip=True)
DELTA = np.float32(0.2)


@pytest.fixture(scope="module")
def problem():
    data_j, _ = jl.generate(jax.random.PRNGKey(0), n_agents=N, m=M, dim=D)
    data_t = convert.data_from_numpy(
        {k: np.asarray(v) for k, v in data_j.items()}, device="cpu")
    return data_j, data_t


def _algs(fused):
    qj, qt = jc.UniformQuantizer(**QUANT), tc.UniformQuantizer(**QUANT)
    aj = jf.FedLT(loss=jl.make_local_loss(50.0, N), uplink=je.EFChannel(qj),
                  downlink=je.EFChannel(qj), fused_uplink=fused, **TUNED)
    at = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(qt),
                  downlink=te.EFChannel(qt), fused_uplink=fused, **TUNED)
    return aj, at


def _masks(rounds=5):
    active = np.random.default_rng(11).random((rounds, N)) < 0.6
    active[:, 0] = True
    assert not active.all()
    return active


def test_data_carry_over_and_solve_global(problem):
    data_j, data_t = problem
    np.testing.assert_array_equal(data_t["a"].numpy(), np.asarray(data_j["a"]))
    assert data_t["a"].dtype == torch.float32
    xbar_j = np.asarray(jl.solve_global(data_j))
    xbar_t = tl.solve_global(data_t).numpy()
    np.testing.assert_allclose(xbar_t, xbar_j, rtol=0, atol=1e-5)


def test_local_loss_and_gradient_match(problem):
    data_j, data_t = problem
    x = np.random.default_rng(12).normal(size=D).astype(np.float32)
    lj, lt = jl.make_local_loss(50.0, N), tl.make_local_loss(50.0, N)
    di_j = jax.tree_util.tree_map(lambda a: a[3], data_j)
    di_t = {k: v[3] for k, v in data_t.items()}
    np.testing.assert_allclose(float(lt(torch.from_numpy(x), di_t)),
                               float(lj(jnp.asarray(x), di_j)), rtol=1e-6)
    np.testing.assert_allclose(
        torch.func.grad(lt)(torch.from_numpy(x), di_t).numpy(),
        np.asarray(jax.grad(lj)(jnp.asarray(x), di_j)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_rounds_match_jax(problem, fused):
    data_j, data_t = problem
    aj, at = _algs(fused)
    xbar_j, xbar_t = jl.solve_global(data_j), tl.solve_global(data_t)
    sj = aj.init(jnp.zeros(D), N)
    st = convert.fedlt_state_from_numpy(sj, device="cpu")
    round_j = jax.jit(aj.round)
    for r, active in enumerate(_masks()):
        prev_j = sj
        sj, info_j = round_j(sj, data_j, jnp.asarray(active), jax.random.PRNGKey(r))
        st, info_t = at.round(st, data_t, torch.from_numpy(active))
        assert int(info_t["n_active"]) == int(info_j["n_active"]) == active.sum()
        got = convert.fedlt_state_to_numpy(st)
        assert got.k == int(sj.k) == r + 1
        for f in ("x", "z", "c_up", "c_down"):
            np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(sj, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{f}, round {r}")
        diff = got.z_hat != np.asarray(sj.z_hat)
        # at most one entry per round may sit on a half-level boundary
        assert diff.sum() <= 1, f"round {r}: {diff.sum()} z_hat entries differ"
        np.testing.assert_array_equal(
            np.abs(got.z_hat[diff] - np.asarray(sj.z_hat)[diff]), DELTA * diff.sum())
        np.testing.assert_allclose(float(tf.optimality_error(st.x, xbar_t)),
                                   float(jf.optimality_error(sj.x, xbar_j)),
                                   rtol=1e-4)
        # the uplink step alone, on JAX's own inputs, bit for bit
        z_next = torch.from_numpy(np.array(sj.z))
        c_prev = torch.from_numpy(np.array(prev_j.c_up))
        if fused:
            wire, c_new = at.uplink.send_fused(z_next, c_prev)
        else:
            wire, c_new = at.uplink.send(None, z_next, c_prev, batch=True)
        act = torch.from_numpy(active)[:, None]
        np.testing.assert_array_equal(
            torch.where(act, c_new, c_prev).numpy().view(np.int32),
            np.asarray(sj.c_up).view(np.int32))
        np.testing.assert_array_equal(
            torch.where(act, wire, torch.from_numpy(np.array(prev_j.z_hat)))
            .numpy().view(np.int32), np.asarray(sj.z_hat).view(np.int32))


def test_run_with_masks_is_the_round_loop(problem):
    _, data_t = problem
    _, at = _algs(True)
    st0 = at.init(torch.zeros(D), N)
    active = _masks(4)
    st_run, info = at.run(st0, data_t, 4, active=active)
    st = st0
    for a in active:
        st, _ = at.round(st, data_t, torch.from_numpy(a))
    for f in ("x", "z", "c_up", "z_hat", "c_down"):
        assert torch.equal(getattr(st_run, f), getattr(st, f))
    assert info["n_active"].tolist() == active.sum(axis=1).tolist()
    with pytest.raises(ValueError, match="expected"):
        at.run(st0, data_t, 3, active=active)


def test_run_draws_bernoulli_masks_from_a_generator(problem):
    _, data_t = problem
    _, at = _algs(True)
    st0 = at.init(torch.zeros(D), N)
    _, info = at.run(st0, data_t, 6, gen=torch.Generator().manual_seed(0),
                     participation=0.5)
    n_active = info["n_active"]
    assert n_active.shape == (6,) and (n_active >= 1).all() and (n_active < N).any()
    _, again = at.run(st0, data_t, 6, gen=torch.Generator().manual_seed(0),
                      participation=0.5)
    assert torch.equal(n_active, again["n_active"])
    _, full = at.run(st0, data_t, 2)
    assert full["n_active"].tolist() == [N, N]
    with pytest.raises(ValueError, match="Generator"):
        at.run(st0, data_t, 2, participation=0.5)


def test_state_converts_both_ways(problem):
    data_j, data_t = problem
    aj, at = _algs(True)
    sj = aj.init(jnp.zeros(D), N)
    sj, _ = jax.jit(aj.round)(sj, data_j, jnp.ones(N, bool), jax.random.PRNGKey(0))
    st = convert.fedlt_state_from_numpy(sj, device="cpu")
    back = convert.fedlt_state_to_numpy(st)
    for f in ("x", "z", "c_up", "z_hat", "c_down", "k"):
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(sj, f)))
    # the numpy state drives the JAX package again
    sj2, _ = jax.jit(aj.round)(jf.FedLTState(*back), data_j, jnp.ones(N, bool),
                               jax.random.PRNGKey(1))
    assert int(sj2.k) == 2
    np.testing.assert_array_equal(convert.data_to_numpy(data_t)["b"],
                                  np.asarray(data_j["b"]))
