"""The space-ified baselines (FedAvg, FedProx, LED, 5GCS): the port against
the JAX package's ``repro.core.baselines``.

Data come from ``repro.data.logistic.generate(PRNGKey(0), n_agents=8,
m=16, dim=10)`` and are carried over with ``repro_torch.convert``; both
packages get the same per-round active masks (numpy, some agents
inactive).  The JAX rounds are compiled with ``jax.jit``, as its
``SpaceRunner`` compiles them.  The compressors are the deterministic
ones, on both links: ``Identity``, the clip=True quantizer (L=10, ±1),
``ScaledSign`` and ``TopK(0.3)``.  ``RandD``'s draws cannot be
reproduced across the packages, so it gets distributional tests only.

Tolerances, each with its reason:

* ``x``, ``m_hat``, ``c_up``, ``c_down``, ``extra``: allclose at rtol
  1e-5, atol 1e-6.  The local gradient's products and the mean over
  agents sum in another order than XLA's, and XLA contracts some
  multiply-adds of the local step that PyTorch rounds twice.
* e_K: rtol 1e-4 in every round.
* The quantizer's ties.  The mean of N=8 lattice points lies on a
  lattice of Δ/8, which holds the half-level boundaries, so the
  downlink's input can sit exactly on one; a last-bit difference in the
  mean's summation order then sends it to the other level.  Such a round
  is recognised by its EF residuals: every entry of ``c_down``/``c_up``
  that disagrees is ±Δ/2 (within 1e-6) in both packages, with opposite
  signs.  The port then redoes the round from its own state before it,
  its quantizer taking the reference's level at those entries, and every
  field must equal the reference's within the tolerances above: the
  flipped levels explain every other difference of the round.  The rounds
  go on from the redone state; any other disagreement fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import channel as jch
from repro.core import baselines as jb
from repro.core import compression as jc
from repro.core import error_feedback as je
from repro.core import fedlt as jf
from repro.data import logistic as jl
from repro_torch import api as tapi
from repro_torch import channel as tch
from repro_torch import convert
from repro_torch.core import baselines as tb
from repro_torch.core import compression as tc
from repro_torch.core import error_feedback as te
from repro_torch.core import fedlt as tf
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.data import logistic as tl
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

N, M, D = 8, 16, 10
COMPRESSORS = {"identity": {}, "quant": dict(levels=10, vmin=-1.0, vmax=1.0, clip=True),
               "sign": {}, "top_k": dict(fraction=0.3)}
ALGOS = ("fedavg", "fedprox", "led", "5gcs")
FIELDS = ("x", "m_hat", "c_up", "c_down", "extra")
HALF = 0.1                      # Δ/2 of the quantizer above


def make(pkg, loss, algo, up, down):
    """benchmarks/common.py's tuned baselines."""
    if algo == "fedavg":
        return pkg.FedAvg(loss=loss, n_epochs=10, gamma=0.05, uplink=up, downlink=down)
    if algo == "fedprox":
        return pkg.FedProx(loss, n_epochs=10, gamma=0.05, prox_mu=1.0, uplink=up,
                           downlink=down)
    if algo == "led":
        return pkg.LED(loss=loss, n_epochs=10, gamma=0.01, uplink=up, downlink=down)
    return pkg.FiveGCS(loss=loss, n_epochs=10, gamma=0.05, gamma_p=1.0, uplink=up,
                       downlink=down)


def algs(algo, comp):
    cj = jc.make_compressor(comp, **COMPRESSORS[comp])
    ct = tc.make_compressor(comp, **COMPRESSORS[comp])
    aj = make(jb, jl.make_local_loss(50.0, N), algo, je.EFChannel(cj), je.EFChannel(cj))
    at = make(tb, tl.make_local_loss(50.0, N), algo, te.EFChannel(ct), te.EFChannel(ct))
    return aj, at


@pytest.fixture(scope="module")
def problem():
    data_j, _ = jl.generate(jax.random.PRNGKey(0), n_agents=N, m=M, dim=D)
    data_t = convert.data_from_numpy({k: np.asarray(v) for k, v in data_j.items()},
                                     device="cpu")
    return data_j, data_t, jl.solve_global(data_j), tl.solve_global(data_t)


def masks(rounds):
    active = np.random.default_rng(11).random((rounds, N)) < 0.6
    active[:, 0] = True
    active[1:2] = True                    # one round with every agent active
    assert not active.all()
    return active


def to_port(sj) -> tb.FedState:
    t = lambda tree: tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return tb.FedState(*(t(jax.tree_util.tree_map(np.asarray, f)) for f in sj[:5]),
                       k=int(sj.k))


def leaves_np(state, field, jax_side):
    tree = getattr(state, field)
    if jax_side:
        return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    return [a.numpy() for a in tree_leaves(tree)]


def mismatch(st, sj):
    """{field: bool mask of entries outside rtol 1e-5, atol 1e-6} where any."""
    out = {}
    for f in FIELDS:
        a, b = leaves_np(st, f, False), leaves_np(sj, f, True)
        assert [x.shape for x in a] == [x.shape for x in b], f
        for x, y in zip(a, b):
            bad = ~np.isclose(x, y, rtol=1e-5, atol=1e-6)
            if bad.any():
                out[f] = bad
    return out


def is_tie(st, sj, bad) -> bool:
    """Every disagreeing EF residual entry is ±Δ/2 in both packages with
    opposite signs: the quantizer's input sat on a half-level boundary."""
    for f in ("c_down", "c_up"):
        if f in bad:
            a, b = leaves_np(st, f, False)[0][bad[f]], leaves_np(sj, f, True)[0][bad[f]]
            if not (np.allclose(np.abs(a), HALF, atol=1e-6)
                    and np.allclose(np.abs(b), HALF, atol=1e-6)
                    and (np.sign(a) == -np.sign(b)).all()):
                return False
    return "c_down" in bad or "c_up" in bad


class Forced:
    """A link's quantizer that takes, at the ``mask`` entries, the level
    whose residual has the sign ``sign`` (the reference's level when the
    input sits on a half-level boundary)."""

    def __init__(self, base, mask, sign):
        self.base, self.mask, self.sign = base, mask, sign

    def __call__(self, gen, x, batch=False):
        out = self.base(gen, x, batch)
        r = x - out
        return torch.where(self.mask & (torch.sign(r) != self.sign),
                           out + 2 * HALF * torch.sign(r), out)


def explain_tie(at, st_prev, data, active, st, sj, bad):
    """The port's round from ``st_prev`` redone with the reference's levels
    at the tie entries, or None when the round is no tie or the redone
    state still differs from the reference's ``sj``."""
    if not is_tie(st, sj, bad):
        return None
    alg = at
    for f, link in (("c_down", "downlink"), ("c_up", "uplink")):
        if f in bad:
            ch = getattr(at, link)
            sign = torch.from_numpy(np.sign(leaves_np(sj, f, True)[0]))
            forced = Forced(ch.compressor, torch.from_numpy(bad[f]), sign)
            alg = dataclasses.replace(alg, **{link: dataclasses.replace(
                ch, compressor=forced)})
    redo, _ = alg.round(st_prev, data, active)
    return None if mismatch(redo, sj) else redo


def run_both(algo, comp, problem, rounds):
    """``rounds`` rounds in both packages; returns the number of tie rounds."""
    data_j, data_t, xbar_j, xbar_t = problem
    aj, at = algs(algo, comp)
    sj, st = aj.init(jnp.zeros(D), N), at.init(torch.zeros(D), N)
    assert tree_map(lambda a: None, st.extra) == jax.tree_util.tree_map(
        lambda a: None, sj.extra)          # (), a bare tree, (h,)
    round_j = jax.jit(aj.round)
    ties = 0
    for r, active in enumerate(masks(rounds)):
        sj, _ = round_j(sj, data_j, jnp.asarray(active), jax.random.PRNGKey(r))
        st_prev = st
        st, _ = at.round(st, data_t, torch.from_numpy(active))
        assert st.k == int(sj.k) == r + 1
        bad = mismatch(st, sj)
        if bad:
            redo = None if comp != "quant" else explain_tie(
                at, st_prev, data_t, torch.from_numpy(active), st, sj, bad)
            assert redo is not None, f"{algo}/{comp} round {r}: {sorted(bad)} differ"
            st, ties = redo, ties + 1
        np.testing.assert_allclose(float(tf.optimality_error(st.x, xbar_t)),
                                   float(jf.optimality_error(sj.x, xbar_j)), rtol=1e-4)
    return ties


@pytest.mark.parametrize("comp", list(COMPRESSORS))
@pytest.mark.parametrize("algo", ALGOS)
def test_one_round_matches_jax(problem, algo, comp):
    assert run_both(algo, comp, problem, 1) == 0


@pytest.mark.parametrize("comp", list(COMPRESSORS))
@pytest.mark.parametrize("algo", ALGOS)
def test_twenty_rounds_match_jax(problem, algo, comp):
    assert run_both(algo, comp, problem, 20) <= 2


def test_a_tie_is_told_from_a_fault(problem):
    """The tie rule accepts a ±Δ/2 flip and nothing else."""
    aj, at = algs("fedavg", "quant")
    sj = aj.init(jnp.zeros(D), N)
    st = to_port(sj)
    c_j = np.zeros(D, np.float32)
    c_j[3] = HALF
    sj = sj._replace(c_down=jnp.asarray(c_j))
    st = st._replace(c_down=torch.from_numpy(-c_j))
    bad = mismatch(st, sj)
    assert list(bad) == ["c_down"] and is_tie(st, sj, bad)
    st = st._replace(c_down=torch.from_numpy(c_j / 2))
    assert not is_tie(st, sj, mismatch(st, sj))
    st = to_port(sj)._replace(x=to_port(sj).x + 1e-3)
    assert not is_tie(st, sj, mismatch(st, sj))


def test_a_tie_round_is_explained_by_its_flipped_levels(problem):
    """An uplink entry put on a half-level boundary: the round with the
    other level there is accepted, with every consequence of the flip;
    the same flip of c_up without its consequence in m_hat is not."""
    _, data_t, _, _ = problem
    _, at = algs("fedavg", "quant")
    active = torch.ones(N, dtype=torch.bool)
    st0 = at.init(torch.zeros(D), N)
    x_new = at.round(st0, data_t, active)[0].x       # FedAvg's x does not read c_up
    c_up = torch.zeros(N, D)
    c_up[2, 3] = HALF - x_new[2, 3]
    st1 = st0._replace(c_up=c_up)                    # uplink input (2, 3) ≈ Δ/2
    ours, _ = at.round(st1, data_t, active)
    assert abs(abs(float(ours.c_up[2, 3])) - HALF) < 1e-6
    mask = torch.zeros(N, D, dtype=torch.bool)
    mask[2, 3] = True
    sign = torch.where(mask, -torch.sign(ours.c_up), torch.sign(ours.c_up))
    flipped = dataclasses.replace(at, uplink=dataclasses.replace(
        at.uplink, compressor=Forced(at.uplink.compressor, mask, sign)))
    ref, _ = flipped.round(st1, data_t, active)
    bad = mismatch(ours, ref)
    assert sorted(bad) == ["c_up", "m_hat"] and bad["c_up"].sum() == 1
    redo = explain_tie(at, st1, data_t, active, ours, ref, bad)
    assert redo is not None and not mismatch(redo, ref)
    fake = ours._replace(c_up=ref.c_up)              # the flip, m_hat unchanged
    bad = mismatch(ours, fake)
    assert list(bad) == ["c_up"] and is_tie(ours, fake, bad)
    assert explain_tie(at, st1, data_t, active, ours, fake, bad) is None


def test_fedavg_starts_from_the_downlink_and_prox_is_fedavg(problem):
    """FedAvg ignores x_i; FedProx is FedAvg with prox_mu > 0."""
    _, data_t, _, _ = problem
    _, at = algs("fedavg", "identity")
    st = at.init(torch.zeros(D), N)
    moved = st._replace(x=st.x + torch.randn(N, D, generator=torch.Generator().manual_seed(0)))
    a, _ = at.round(st, data_t, torch.ones(N, dtype=torch.bool))
    b, _ = at.round(moved, data_t, torch.ones(N, dtype=torch.bool))
    assert torch.equal(a.x, b.x) and torch.equal(a.m_hat, b.m_hat)
    prox = tb.FedProx(at.loss, n_epochs=10, gamma=0.05, prox_mu=1.0)
    assert isinstance(prox, tb.FedAvg) and prox.prox_mu == 1.0
    assert (a.extra, at.init(torch.zeros(D), N).k) == ((), 0)


def test_five_gcs_with_no_agent_active_keeps_its_state(problem):
    """n_act is clamped to 1: an empty active set divides by 1, not 0."""
    _, data_t, _, _ = problem
    _, at = algs("5gcs", "identity")
    st = at.init(torch.zeros(D), N)
    st1, _ = at.round(st, data_t, torch.zeros(N, dtype=torch.bool))
    for f in ("x", "m_hat", "c_up"):
        assert torch.equal(getattr(st1, f), getattr(st, f))
    assert torch.equal(st1.extra[0], st.extra[0]) and torch.isfinite(st1.c_down).all()


@pytest.mark.parametrize("algo", ALGOS)
def test_rand_d_keeps_exactly_d_values_per_agent(problem, algo):
    """RandD(0.2) on the uplink: every active agent's received wire has
    exactly round(0.2·d) nonzeros, inactive agents keep theirs, and over
    rounds every coordinate is kept about as often (χ² test)."""
    _, data_t, _, _ = problem
    c = tc.RandD(0.2)
    at = make(tb, tl.make_local_loss(50.0, N), algo, te.EFChannel(c),
              te.EFChannel(tc.Identity()))
    d_keep = round(0.2 * D)
    gen = torch.Generator().manual_seed(5)
    st = at.init(torch.randn(D, generator=gen) + 3.0, N)
    kept = np.zeros(D)
    for active in masks(40):
        prev = st
        st, _ = at.round(st, data_t, torch.from_numpy(active), gen)
        nz = (st.m_hat != 0).sum(dim=1).numpy()
        assert (nz[active] == d_keep).all(), nz
        assert torch.equal(st.m_hat[~torch.from_numpy(active)],
                           prev.m_hat[~torch.from_numpy(active)])
        kept += (st.m_hat[torch.from_numpy(active)] != 0).sum(dim=0).numpy()
    expect = kept.sum() / D
    chi2 = float(((kept - expect) ** 2 / expect).sum())
    assert chi2 < 27.9            # χ² with 9 degrees of freedom at p = 0.001


@pytest.mark.parametrize("algo", ALGOS)
def test_run_with_masks_is_the_round_loop(problem, algo):
    _, data_t, _, _ = problem
    _, at = algs(algo, "top_k")
    st0 = at.init(torch.zeros(D), N)
    active = masks(4)
    st_run, info = at.run(st0, data_t, 4, active=active)
    st = st0
    for a in active:
        st, _ = at.round(st, data_t, torch.from_numpy(a))
    assert info == {} and st_run.k == 4
    for x, y in zip(tree_leaves(st_run[:5]), tree_leaves(st[:5])):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="expected"):
        at.run(st0, data_t, 3, active=active)
    with pytest.raises(ValueError, match="Generator"):
        at.run(st0, data_t, 2, participation=0.5)
    st_b, _ = at.run(st0, data_t, 3, gen=torch.Generator().manual_seed(0),
                     participation=0.5)
    st_c, _ = at.run(st0, data_t, 3, gen=torch.Generator().manual_seed(0),
                     participation=0.5)
    assert torch.equal(st_b.x, st_c.x) and st_b.k == 3


# -- through Experiment: FedAvg with TopK on the constellation -------------

SAT_N, SAT_M, SAT_D = 100, 16, 8
EXACT = ("round", "time", "bytes_up", "n_active", "n_lost", "bytes_isl", "staleness")
EXP_CASES = {
    "sync-cohort": dict(scenario="walker-kiruna", rounds=6, kw=dict(measure="cohort")),
    # a harsh channel (30% segment loss, one ARQ round) makes the
    # loss-robust revert of m_hat and c_up run
    "lossy-robust": dict(scenario="lossy-uplink", rounds=6, channel=0.3,
                         kw=dict(measure="cohort", loss_robust=True)),
    "async-dual-station": dict(scenario="dual-station", rounds=5,
                               kw=dict(mode="async", buffer_size=10)),
}


@pytest.fixture(scope="module")
def sat_problem():
    data_j, _ = jl.generate(jax.random.PRNGKey(1), n_agents=SAT_N, m=SAT_M, dim=SAT_D)
    data_t = convert.data_from_numpy({k: np.asarray(v) for k, v in data_j.items()},
                                     device="cpu")
    return data_j, data_t, jl.solve_global(data_j), tl.solve_global(data_t)


@pytest.mark.parametrize("case", list(EXP_CASES))
def test_fedavg_through_experiment_matches_jax(sat_problem, case):
    data_j, data_t, xbar_j, xbar_t = sat_problem
    cfg = EXP_CASES[case]
    res = {}
    for pkg, cpkg, epkg, lpkg, chpkg, japi_side in (
            (jb, jc, je, jl, jch, True), (tb, tc, te, tl, tch, False)):
        C = cpkg.TopK(0.5)
        alg = pkg.FedAvg(loss=lpkg.make_local_loss(50.0, SAT_N), n_epochs=10,
                         gamma=0.05, uplink=epkg.EFChannel(C), downlink=epkg.EFChannel(C))
        channel = (chpkg.ChannelModel(loss=cfg["channel"], arq=chpkg.SelectiveRepeatARQ(
            seg_bytes=4096, max_rounds=1)) if "channel" in cfg else None)
        if japi_side:
            exp = japi.Experiment.from_scenario(cfg["scenario"], algorithm=alg,
                                                compressor=C, channel=channel, **cfg["kw"])
            res["jax"] = exp.run(exp.init(jnp.zeros(SAT_D), SAT_N), data_j, cfg["rounds"],
                                 jax.random.PRNGKey(2), log_every=1,
                                 error_fn=lambda s: jf.optimality_error(s.x, xbar_j))
        else:
            exp = tapi.Experiment.from_scenario(cfg["scenario"], algorithm=alg,
                                                compressor=C, channel=channel,
                                                device="cpu", **cfg["kw"])
            res["port"] = exp.run(exp.init(torch.zeros(SAT_D), SAT_N), data_t,
                                  cfg["rounds"], 2, log_every=1,
                                  error_fn=lambda s: tf.optimality_error(s.x, xbar_t))
    rj, rt = res["jax"], res["port"]
    assert len(rt.logs) == len(rj.logs) == cfg["rounds"]
    for a, b in zip(rt.logs, rj.logs):
        for f in EXACT:
            assert getattr(a, f) == getattr(b, f), (case, a.round, f)
        np.testing.assert_allclose(a.error, b.error, rtol=1e-4)
    for f in ("x", "m_hat", "c_up"):
        np.testing.assert_allclose(getattr(rt.state, f).numpy(),
                                   np.asarray(getattr(rj.state, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    if case.startswith("lossy"):
        assert sum(lg.n_lost for lg in rt.logs) > 0      # the revert ran


def test_sparse_cohort_bytes_match_jax(sat_problem):
    """measure="cohort" with a sparse codec encodes every landed update from
    the transmitted wire state (one pack_bits dispatch each, and one for
    the probe).  RandD keeps exactly round(fraction·n) values, so the bytes
    equal the JAX package's though the draws differ."""
    data_j, data_t, _, _ = sat_problem
    logs = {}
    for pkg, cpkg, epkg, lpkg, api in ((jb, jc, je, jl, japi), (tb, tc, te, tl, tapi)):
        C = cpkg.RandD(0.5)
        alg = pkg.FedAvg(loss=lpkg.make_local_loss(50.0, SAT_N), n_epochs=2, gamma=0.05,
                         uplink=epkg.EFChannel(C), downlink=epkg.EFChannel(C))
        kw = {} if api is japi else dict(device="cpu")
        exp = api.Experiment.from_scenario("walker-kiruna", algorithm=alg, compressor=C,
                                           measure="cohort", **kw)
        x0 = jnp.zeros(SAT_D) if api is japi else torch.zeros(SAT_D)
        seed = jax.random.PRNGKey(2) if api is japi else 2
        res = exp.run(exp.init(x0, SAT_N), data_j if api is japi else data_t, 4, seed,
                      trace=api is tapi)
        logs[api] = res.logs
    for a, b in zip(logs[tapi], logs[japi]):
        assert (a.round, a.time, a.bytes_up, a.n_active) == (b.round, b.time, b.bytes_up,
                                                            b.n_active)
    packs = [r for r in res.records if r.get("kind") == "kernel"
             and r["name"] == "pack_bits"]
    assert len(packs) == 1 + sum(lg.n_active for lg in logs[tapi])
