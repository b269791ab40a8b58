"""Fed-LTSat (Algorithm 3) through ``Experiment``: the port against the JAX
package.

Both packages run the same scenario on their own engine copy (equal
timelines, ``tests/test_torch_sim.py``) with Fed-LT, the paper's coarse
quantizer (L=10, ±1, clip) both ways and EF on.  Data come from
``repro.data.logistic.generate(PRNGKey(0), n_agents=100, m=16, dim=8)``
and are carried over with ``repro_torch.convert``; the JAX rounds are
compiled with ``jax.jit``, as its ``SpaceRunner`` compiles them.

Tolerances, each with its reason:

* ``RoundLog.round``/``time``/``bytes_up``/``n_active``/``n_lost``/
  ``bytes_isl``/``staleness``: exact.  They come from the engine and the
  byte accounting, numpy on both sides, and from the masks they feed.
* ``RoundLog.error`` (e_K): rtol 1e-4.  The local gradient's products
  and the mean over agents sum in another order than XLA's.
* the final ``x``: allclose at rtol 1e-4, atol 1e-5, for the same reason
  carried over the rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import channel as jch
from repro.core import compression as jc
from repro.core import error_feedback as je
from repro.core import fedlt as jf
from repro.data import logistic as jl
from repro_torch import api as tapi
from repro_torch import channel as tch
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.core import compression as tc
from repro_torch.core import error_feedback as te
from repro_torch.core import fedlt as tf
from repro_torch.data import logistic as tl
from repro_torch.kernels import ops
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

N, M, D = 100, 16, 8
TUNED = dict(n_epochs=10, gamma=0.005, rho=20.0)
QUANT = dict(levels=10, vmin=-1.0, vmax=1.0, clip=True)
EXACT = ("round", "time", "bytes_up", "n_active", "n_lost", "bytes_isl",
         "staleness")

CASES = {
    "sync-cohort-fused": dict(scenario="walker-kiruna", rounds=8, fused=True,
                              kw=dict(measure="cohort")),
    "sync-probe": dict(scenario="walker-kiruna", rounds=6, fused=False,
                       kw=dict(measure="probe")),
    "async-dual-station": dict(scenario="dual-station", rounds=6, fused=True,
                               kw=dict(mode="async", buffer_size=10)),
    # the scenario's ARQ recovers nearly every segment: a harsher channel
    # (30% segment loss, one ARQ round) makes the revert run
    "lossy-robust": dict(scenario="lossy-uplink", rounds=8, fused=True,
                         kw=dict(measure="cohort", loss_robust=True),
                         channel=0.3),
    "lossy-naive": dict(scenario="lossy-uplink", rounds=8, fused=False,
                        kw=dict(measure="cohort", loss_robust=False),
                        channel=0.3),
    "chaos-deadline-quorum": dict(scenario="chaos-direct", rounds=8, fused=True,
                                  kw=dict(deadline=40.0, quorum=0.6)),
    "plane-topology": dict(scenario="plane-agg-walker", rounds=4, fused=True,
                           kw=dict(measure="probe")),
}


@pytest.fixture(scope="module")
def problem():
    data_j, _ = jl.generate(jax.random.PRNGKey(0), n_agents=N, m=M, dim=D)
    data_np = {k: np.asarray(v) for k, v in data_j.items()}
    xbar_j = jl.solve_global(data_j)
    return data_j, xbar_j, convert.data_from_numpy(data_np, device="cpu"), \
        torch.from_numpy(np.array(xbar_j))


def _channel(pkg, cfg):
    if "channel" not in cfg:
        return None
    return pkg.ChannelModel(loss=cfg["channel"],
                            arq=pkg.SelectiveRepeatARQ(seg_bytes=4096, max_rounds=1))


def _run_jax(problem, case, trace=False):
    data_j, xbar_j, _, _ = problem
    cfg = CASES[case]
    q = jc.UniformQuantizer(**QUANT)
    alg = jf.FedLT(loss=jl.make_local_loss(50.0, N), uplink=je.EFChannel(q),
                   downlink=je.EFChannel(q), fused_uplink=cfg["fused"], **TUNED)
    exp = japi.Experiment.from_scenario(cfg["scenario"], algorithm=alg, compressor=q,
                                        channel=_channel(jch, cfg), **cfg["kw"])
    return exp.run(exp.init(jnp.zeros(D), N), data_j, cfg["rounds"],
                   jax.random.PRNGKey(2), log_every=2, trace=trace,
                   error_fn=lambda s: jf.optimality_error(s.x, xbar_j))


def _run_port(problem, case, trace=False):
    _, _, data_t, xbar_t = problem
    cfg = CASES[case]
    q = tc.UniformQuantizer(**QUANT)
    alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(q),
                   downlink=te.EFChannel(q), fused_uplink=cfg["fused"], **TUNED)
    exp = tapi.Experiment.from_scenario(cfg["scenario"], algorithm=alg, compressor=q,
                                        channel=_channel(tch, cfg), device="cpu",
                                        **cfg["kw"])
    return exp.run(exp.init(torch.zeros(D), N), data_t, cfg["rounds"], 2,
                   log_every=2, trace=trace,
                   error_fn=lambda s: tf.optimality_error(s.x, xbar_t))


def _run_both(problem, case, trace=False):
    return _run_jax(problem, case, trace), _run_port(problem, case, trace)


@pytest.mark.parametrize("case", list(CASES))
def test_round_logs_and_state_match(problem, case):
    chaos = case.startswith("chaos")
    rj, rt = _run_both(problem, case, trace=chaos)
    assert len(rt.logs) == len(rj.logs) > 0
    for a, b in zip(rt.logs, rj.logs):
        for f in EXACT:
            assert getattr(a, f) == getattr(b, f), (case, a.round, f)
        assert (a.error is None) == (b.error is None)
        if a.error is not None:
            np.testing.assert_allclose(a.error, b.error, rtol=1e-4)
    np.testing.assert_allclose(rt.state.x.numpy(), np.asarray(rj.state.x),
                               rtol=1e-4, atol=1e-5)
    if case.startswith(("lossy", "chaos")):
        # the revert ran: lost uplinks, or stragglers past the deadline
        assert sum(lg.n_lost for lg in rt.logs) > 0
    if chaos:
        # crashed satellites' EF caches were re-synced, as in the reference
        resync = lambda recs: [r["sats"] for r in recs if r["kind"] == "ef_resync"]
        assert resync(rt.records) == resync(rj.records) != []


def test_traced_run_records_match(problem):
    """``trace=True`` through the port's obs: the fl_round records and the
    e_K / bytes_up series equal the JAX package's (e_K at rtol 1e-4)."""
    rj, rt = _run_both(problem, "lossy-robust", trace=True)

    def rounds(recs):
        return [{k: v for k, v in r.items() if k not in ("t_wall", "error")}
                for r in recs if r.get("kind") == "fl_round"]

    assert rounds(rt.records) == rounds(rj.records)
    kinds = lambda recs: sorted({r.get("kind") for r in recs})
    assert kinds(rt.records) == kinds(rj.records)
    sj = [r for r in rj.records if r.get("kind") == "series"]
    st = [r for r in rt.records if r.get("kind") == "series"]
    assert [(r["name"], r["step"]) for r in st] == [(r["name"], r["step"]) for r in sj]
    for a, b in zip(st, sj):
        if a["name"] in ("bytes_up", "bytes_down", "lost_frac", "survivors"):
            assert a["value"] == b["value"]
        else:
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4, atol=1e-6)
    assert rt.records[0]["scenario"] == "lossy-uplink"


def test_fused_uplink_launch_path_counts_no_launch_on_cpu(problem):
    """On the CPU the wrappers take the plain versions: no launch counted."""
    before = ops.launch_counts()
    _run_port(problem, "sync-cohort-fused")
    assert ops.launch_counts() == before


def test_not_ported_options_raise(problem, tmp_path):
    """Checkpoints and the ledger are ported (``tests/test_torch_checkpoint.py``,
    ``tests/test_torch_ledger.py``); what the reference refuses, the port
    refuses too.  Sharded checkpoints are ported as well: ``specs=`` is
    recorded in the meta as the JAX package records it."""
    _, _, data_t, _ = problem
    q = tc.UniformQuantizer(**QUANT)
    alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(q),
                   downlink=te.EFChannel(q), **TUNED)
    exp = tapi.Experiment("walker-kiruna", alg, compressor=q, device="cpu")
    st = exp.init(torch.zeros(D), N)
    with pytest.raises(ValueError, match="checkpoint"):
        exp.run(st, data_t, 1, resume=True)
    with pytest.raises(ValueError, match="no trace records"):
        tapi.ExperimentResult(st, []).ingest(str(tmp_path / "l.jsonl"))
    store.save(str(tmp_path / "ck"), st, specs={"x": "fleet-spec"})
    assert store.load_meta(str(tmp_path / "ck"))["specs"] == {"['x']": "fleet-spec"}
    with pytest.raises(ValueError, match="sync-only"):
        tapi.Experiment("walker-kiruna", alg, mode="async", measure="cohort",
                        device="cpu")
    assert tapi.describe_compressor(q) == "quant10"
    assert exp.ledger_meta()["channel"] == "lossless"
