"""The lossy-EF, fault-tolerance and plane-aggregation tables on the port
(``repro_torch.bench.table_*``) against the JAX package's ``benchmarks/``.

Both packages run the same problem: the reference's modules draw it with
``jax.random`` and the port's are handed the same arrays through
``repro_torch.convert`` (their ``logistic_problem`` is replaced for the
test).  The runs are cut to a few rounds and narrow models; ledgers and
JSON go to temporary directories on both sides.  Rows come from each
package's ledger only.

Tolerances: loss rates, crash rates, arms, topologies, bytes, loss and
update counts and simulated times are equal (the engines are the same
numpy code and the byte accounting does not depend on the draws); e_K is
within rtol 1e-4 (float32 sums run in another order than XLA's).
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from benchmarks import table_fault_tolerance as jfault
from benchmarks import table_lossy_ef as jlossy
from benchmarks import table_plane_agg as jplane
from repro.data import logistic as jl
from repro_torch import convert
from repro_torch.bench import table_fault_tolerance as tfault
from repro_torch.bench import table_lossy_ef as tlossy
from repro_torch.bench import table_plane_agg as tplane
from repro_torch.core.fedlt import optimality_error
from repro_torch.data import logistic as tl
from repro_torch.sim import Engine
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

EXACT = {
    "lossy": ("loss_rate", "arm", "lost", "received", "bytes_up"),
    "fault": ("crash_rate", "arm", "quorum", "faults", "bytes_up", "lost",
              "t_sim", "quorum_frac"),
    "plane": ("arm", "topology", "scenario", "rounds", "bytes_gs", "bytes_isl",
              "updates", "lost"),
}


def reference_problem(seed=0, *, n_agents, m, dim, device=None):
    """The JAX package's problem (its ``generate`` and ``solve_global``),
    carried over to the port on the CPU."""
    data, _ = jl.generate(jax.random.PRNGKey(seed), n_agents=n_agents, m=m,
                          dim=dim)
    x_star = convert.data_from_numpy(np.array(jl.solve_global(data, eps=50.0)),
                                     device="cpu")
    data = convert.data_from_numpy({k: np.asarray(v) for k, v in data.items()},
                                   device="cpu")
    return data, tl.make_local_loss(eps=50.0, n_agents=n_agents), x_star


@pytest.fixture
def same_problem(monkeypatch, tmp_path):
    for mod in (tlossy, tfault, tplane):
        monkeypatch.setattr(mod, "logistic_problem", reference_problem)
    for mod in (tlossy, tfault, tplane, jlossy, jfault, jplane):
        monkeypatch.setattr(mod, "RESULTS_DIR", str(tmp_path / mod.__name__))
    return tmp_path


def _assert_rows(ours, theirs, kind):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for f in EXACT[kind]:
            assert a[f] == b[f], (kind, f, a, b)
        np.testing.assert_allclose(a["error"], b["error"], rtol=1e-4,
                                   err_msg=str(a))


def test_constants_are_the_references():
    assert tlossy.ARMS == jlossy.ARMS
    assert tfault.ARMS == jfault.ARMS
    assert (tfault.ROBUST, tfault.NAIVE, tfault.HEAD_FAILURE_RATE,
            tfault.FAILOVER_TIMEOUT) == (jfault.ROBUST, jfault.NAIVE,
                                         jfault.HEAD_FAILURE_RATE,
                                         jfault.FAILOVER_TIMEOUT)
    ours, theirs = tfault._scenario(), jfault._scenario()
    assert ours.name == theirs.name
    np.testing.assert_array_equal(ours.compute_time, theirs.compute_time)
    assert tplane.WALKER_ARMS == jplane.WALKER_ARMS
    for (a, s), (b, r) in zip(tplane.MEGA_ARMS(), jplane.MEGA_ARMS()):
        assert a == b and s.name == r.name
        assert (s.k_direct, s.n_relay) == (r.k_direct, r.n_relay)
    row = dict(loss_rate=0.2, arm="no EF", error=0.5, lost=3, received=9,
               bytes_up=1234.5, crash_rate=0.1, t_sim=99.0, topology="plane",
               scenario="s", bytes_gs=10.0, bytes_isl=5.0, updates=4)
    for t, j in ((tlossy, jlossy), (tfault, jfault), (tplane, jplane)):
        assert t.render_row(row) == j.render_row(row)
        assert t.LEDGER.replace("\\", "/").endswith(
            "results/torch/" + j.LEDGER.replace("\\", "/").rsplit("/", 1)[1])


def test_lossy_table_matches_the_reference(same_problem):
    kw = dict(rounds=20, dim=8, m=16, verbose=False)
    ours = tlossy.run([0.0, 0.2], device="cpu",
                      ledger_path=str(same_problem / "t.jsonl"), **kw)
    theirs = jlossy.run([0.0, 0.2], ledger_path=str(same_problem / "j.jsonl"), **kw)
    _assert_rows(ours, theirs, "lossy")
    assert sum(r["lost"] for r in ours) > 0
    assert len({r["error"] for r in ours}) > 1      # the arms differ


def test_fault_table_matches_the_reference(same_problem):
    kw = dict(rounds=10, dim=8, m=16, verbose=False)
    ours = tfault.run([0.0, 0.1], device="cpu",
                      ledger_path=str(same_problem / "t.jsonl"), **kw)
    theirs = jfault.run([0.0, 0.1], ledger_path=str(same_problem / "j.jsonl"), **kw)
    _assert_rows(ours, theirs, "fault")
    assert sum(r["lost"] for r in ours) > 0


def test_make_arm_runs_the_tables_arm(same_problem):
    """``make_arm`` builds the sweep's arms: run in the sweep's order on one
    engine, they give the rows' e_K, bytes and simulated time.  Rounds
    depend on the contact plan's horizon, which the shared engine keeps
    between arms: the naive arm at crash rate 0.0 starts on the horizon the
    robust arm grew, and alone on a fresh engine it runs another timeline
    unless its plan is first grown to that horizon (ROADMAP Queue 3; the
    reference's sweep shares its engine the same way)."""
    rounds, dim, m = 60, 100, 16      # the table's d: its messages' bytes
    rows = tfault.run([0.0], rounds=rounds, dim=dim, m=m, verbose=False,
                      device="cpu", ledger_path=str(same_problem / "t.jsonl"))
    data, loss, x_star = reference_problem(0, n_agents=100, m=m, dim=dim)

    def run_arm(arm, engine):
        exp = tfault.make_arm(loss, 0.0, arm, engine, device="cpu")
        res = exp.run(exp.init(torch.zeros(dim), 100), data, rounds,
                      tfault.RUN_SEED, log_every=rounds,
                      error_fn=lambda s: float(optimality_error(s.x, x_star)))
        last = res.logs[-1]
        return last.error, last.bytes_up, last.time

    shared = Engine(tfault._scenario())
    starts = []
    for row, arm in zip(rows, tfault.ARMS):
        assert row["arm"] == arm[0]
        starts.append(shared.plan.horizon)
        assert run_arm(arm, shared) == (row["error"], row["bytes_up"],
                                        row["t_sim"])
    naive = rows[1]
    assert starts[1] > starts[0]
    assert run_arm(tfault.ARMS[1], Engine(tfault._scenario()))[2] != naive["t_sim"]
    grown = Engine(tfault._scenario())
    grown.ensure(grown.plan.t_start + starts[1])
    assert run_arm(tfault.ARMS[1], grown) == (naive["error"], naive["bytes_up"],
                                              naive["t_sim"])


@pytest.mark.parametrize("sweep", ["walker", "mega"])
def test_plane_agg_sweeps_match_the_reference(same_problem, sweep):
    from repro_torch.obs.report import plane_agg_rows as trows
    from repro.obs.report import plane_agg_rows as jrows
    if sweep == "walker":
        t_arms, j_arms, kw = tplane.WALKER_ARMS, jplane.WALKER_ARMS, dict(
            rounds=4, n_agents=100, dim=8, m=16)
    else:
        t_arms, j_arms, kw = tplane.MEGA_ARMS(), jplane.MEGA_ARMS(), dict(
            rounds=2, n_agents=1000, dim=4, m=8)
    ours = tplane.run_sweep(t_arms, group=sweep, device="cpu",
                            ledger_path=str(same_problem / "t.jsonl"), **kw)
    theirs = jplane.run_sweep(j_arms, group=sweep,
                              ledger_path=str(same_problem / "j.jsonl"), **kw)
    _assert_rows(trows(ours), jrows(theirs), "plane")
    assert any(r["bytes_isl"] > 0 for r in trows(ours))


def test_plane_agg_smoke_matches_the_reference(capsys):
    assert tplane.smoke() is True
    ours = capsys.readouterr().out
    assert jplane.smoke() is True
    assert ours == capsys.readouterr().out
    assert ours.startswith("topology-equivalence OK: 4 plane rounds")


def _shorten(monkeypatch, mod, name, **cut):
    sizes, real = [], getattr(mod, name)

    def short(*args, **kw):
        sizes.append((args, dict(kw)))
        return real(*args, **{**kw, **cut})

    monkeypatch.setattr(mod, name, short)
    return sizes


def test_csv_lines(same_problem, monkeypatch, capsys):
    led = lambda name: str(same_problem / name)  # noqa: E731 (not results/torch)
    sizes = _shorten(monkeypatch, tlossy, "run", rounds=4, dim=8, m=16,
                     ledger_path=led("lossy.jsonl"))
    assert tlossy.main(quick=True, device="cpu") in (True, False)
    assert sizes == [(([0.0, 0.1, 0.2],), dict(rounds=500, device="cpu"))]
    assert re.search(r"^table_lossy_ef,\d+,ef_dominates=[01],"
                     r"mean_noef_over_ef=\d+\.\d\d$", capsys.readouterr().out, re.M)

    sizes = _shorten(monkeypatch, tfault, "run", rounds=4, dim=8, m=16,
                     ledger_path=led("fault.jsonl"))
    assert tfault.main(quick=False, device="cpu") in (True, False)
    assert sizes == [(([0.0, 0.05, 0.1],), dict(rounds=300, device="cpu"))]
    assert re.search(r"^table_fault_tolerance,\d+,robust_dominates=[01],"
                     r"mean_naive_over_robust=\d+\.\d\d,mean_tsim_speedup=\d+\.\d\d$",
                     capsys.readouterr().out, re.M)

    sizes = _shorten(monkeypatch, tplane, "run_sweep", rounds=2, dim=4, m=8,
                     ledger_path=led("plane.jsonl"))
    assert tplane.main(quick=True, device="cpu") in (True, False)
    assert [kw["rounds"] for _, kw in sizes] == [20, 4]
    assert [kw["n_agents"] for _, kw in sizes] == [100, 1000]
    out = capsys.readouterr().out
    assert re.search(r"^table_plane_agg,\d+,gs_bytes_per_update_reduction="
                     r"\d+\.\d,ek_ratio_plane_over_direct=\d+\.\d{3}$", out, re.M)
    assert re.search(r"^acceptance: reduction>=5x (PASS|FAIL), "
                     r"ek_ratio<=1.25 (PASS|FAIL)$", out, re.M)
    assert len(re.findall(r" ms/round$", out, re.M)) == 6
    assert (same_problem / tplane.__name__ / "table_plane_agg.json").exists()
    assert dataclasses.is_dataclass(tplane._mega_full())
