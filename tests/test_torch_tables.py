"""The paper's tables and figure on the port (``repro_torch.bench``) against
the JAX package's ``benchmarks/``.

Both packages run the same problem: the reference's ``problem`` draws it
with ``jax.random``, and the port's table modules are handed the same
arrays through ``repro_torch.convert`` (their ``problem`` is replaced for
the test).  The runs are tiny (``scale=0.05`` or ``0.2``, a few rounds)
and results go to a temporary directory on both sides.

Tolerances: the structure and keys of every result are equal; e_K is
within rtol 1e-4 (the local gradient's products and the mean over agents
sum in another order than XLA's).  Table 2's RandD cells draw their own
random numbers in each package, so only their keys and finiteness are
compared.
"""
import math
import re

import numpy as np
import pytest

from benchmarks import common as jcommon
from benchmarks import fig4_trajectory as jfig4
from benchmarks import table1_error_feedback as jt1
from benchmarks import table2_space_comparison as jt2
from repro_torch import convert
from repro_torch.bench import common as tcommon
from repro_torch.bench import fig4_trajectory as tfig4
from repro_torch.bench import kernel_bench as tkernel
from repro_torch.bench import run as trun
from repro_torch.bench import sim_scale as tsim
from repro_torch.bench import table1_error_feedback as tt1
from repro_torch.bench import table2_space_comparison as tt2
from repro_torch.bench import table_fault_tolerance as tfault
from repro_torch.bench import table_lossy_ef as tlossy
from repro_torch.bench import wire_bench as twire
from repro_torch.data import logistic as tl
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()


def reference_problem(seed=0, scale=1.0, device=None):
    """The JAX package's problem, carried over to the port on the CPU."""
    data, _, _, n_agents = jcommon.problem(seed=seed, scale=scale)
    data_t = convert.data_from_numpy({k: np.asarray(v) for k, v in data.items()},
                                     device="cpu")
    return (data_t, tl.make_local_loss(eps=50.0, n_agents=n_agents),
            tl.solve_global(data_t, eps=50.0), n_agents)


@pytest.fixture
def same_problem(monkeypatch, tmp_path):
    for mod in (tt1, tt2, tfig4):
        monkeypatch.setattr(mod, "problem", reference_problem)
    for mod in (tt1, tt2, tfig4, jt1, jt2, jfig4):
        monkeypatch.setattr(mod, "RESULTS_DIR", str(tmp_path / mod.__name__))


def test_common_matches_the_reference():
    assert tcommon.PAPER == jcommon.PAPER and tcommon.TUNED == jcommon.TUNED
    assert list(tcommon.COMPRESSORS) == list(jcommon.COMPRESSORS)
    for name, c in tcommon.COMPRESSORS.items():
        assert type(c).__name__ == type(jcommon.COMPRESSORS[name]).__name__
        assert vars(c) == vars(jcommon.COMPRESSORS[name])
    for algo in tt2.ALGOS:
        ours = tcommon.make_algorithm(algo, None, tcommon.COMPRESSORS["quant_coarse"])
        theirs = jcommon.make_algorithm(algo, None, jcommon.COMPRESSORS["quant_coarse"])
        assert type(ours).__name__ == type(theirs).__name__
        for f in ("n_epochs", "gamma", "rho", "prox_mu", "gamma_p", "server_lr"):
            assert getattr(ours, f, None) == getattr(theirs, f, None), (algo, f)
    assert tcommon.RESULTS_DIR.replace("\\", "/").endswith("results/torch")
    data, _, xbar, n = tcommon.problem(seed=1, scale=0.05, device="cpu")
    assert (n, tuple(data["a"].shape), tuple(xbar.shape)) == (5, (5, 25, 100), (100,))


def test_table1_matches_the_reference(same_problem):
    ours = tt1.run(mc_runs=2, rounds=5, scale=0.05, verbose=False, device="cpu")
    theirs = jt1.run(mc_runs=2, rounds=5, scale=0.05, verbose=False)
    assert [(r["config"], r["algorithm"]) for r in ours] == \
        [(r["config"], r["algorithm"]) for r in theirs]
    assert tt1.CONFIGS == jt1.CONFIGS
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-4)
        np.testing.assert_allclose(a["std"], b["std"], rtol=1e-3, atol=1e-6 * b["mean"])


def test_fig4_matches_the_reference(same_problem):
    ours = tfig4.run(rounds=7, every=3, scale=0.05, device="cpu")
    theirs = jfig4.run(rounds=7, every=3, scale=0.05)
    assert set(ours) == set(theirs) == {False, True}
    for ef in (False, True):
        assert [k for k, _ in ours[ef]] == [k for k, _ in theirs[ef]] == [0, 3, 6]
        np.testing.assert_allclose([e for _, e in ours[ef]], [e for _, e in theirs[ef]],
                                   rtol=1e-4)


def test_table2_matches_the_reference(same_problem, monkeypatch):
    ours = tt2.run(mc_runs=1, rounds=3, scale=0.2, verbose=False, device="cpu")
    assert set(ours) == {(c, a) for c in jt2.COMPRESSORS for a in jt2.ALGOS}
    assert (tt2.ALGOS, tt2.LABEL) == (jt2.ALGOS, jt2.LABEL)
    # the reference on its deterministic columns only: RandD draws differ
    quant = {c: v for c, v in jt2.COMPRESSORS.items() if c.startswith("quant")}
    monkeypatch.setattr(jt2, "COMPRESSORS", quant)
    theirs = jt2.run(mc_runs=1, rounds=3, scale=0.2, verbose=False)
    assert set(theirs) == {k for k in ours if k[0] in quant}
    for key, (m, s) in ours.items():
        assert math.isfinite(m) and s == 0.0
        if key in theirs:
            np.testing.assert_allclose(m, theirs[key][0], rtol=1e-4, err_msg=str(key))


def test_table2_engine_is_the_reference_scenario():
    """benchmarks/table2_space_comparison.py builds this Scenario inline."""
    ours = tt2.make_engine(0.2).scenario
    assert (ours.name, ours.k_direct, ours.n_relay, len(ours.stations)) == \
        ("table2", 4, 2, 1)
    assert (ours.walker.n_sats, ours.walker.n_planes) == (20, 2)
    full = tt2.make_engine(1.0).scenario.walker
    assert (full.n_sats, full.n_planes) == (100, 10)


def test_csv_lines_and_the_driver(same_problem, monkeypatch, capsys):
    sizes, run = [], tt2.run

    def short(**kw):          # quick mode's sizes, cut to 2 rounds here
        sizes.append(kw)
        return run(**{**kw, "rounds": 2})

    monkeypatch.setattr(tt2, "run", short)
    w = tt2.main(quick=True, device="cpu")
    assert sizes == [dict(mc_runs=1, rounds=150, scale=0.2, device="cpu")]
    assert re.search(r"^table2_space_comparison,\d+,fedltsat_wins=\d/4$",
                     capsys.readouterr().out, re.M) and 0 <= w <= 4
    assert tt2.wins({(c, a): (1.0 if a == "fedlt" else 2.0, 0.0)
                     for c in tcommon.COMPRESSORS for a in tt2.ALGOS}) == 4
    calls = []
    for mod in (tt1, tlossy, tfault, tfig4, tt2):
        monkeypatch.setattr(mod, "main", lambda quick, mod=mod: calls.append(
            (mod.__name__, quick)))
    # the sections after Table 2, with benchmarks/run.py's arguments
    monkeypatch.setattr(tsim, "main", lambda quick: calls.append(
        (tsim.__name__, quick)))
    monkeypatch.setattr(tkernel, "main", lambda: calls.append(
        (tkernel.__name__, None)))
    monkeypatch.setattr(twire, "main", lambda tiny: calls.append(
        (twire.__name__, tiny)))
    monkeypatch.setattr("sys.argv", ["run"])
    trun.main()
    assert calls == [(tt1.__name__, True), (tlossy.__name__, True),
                     (tfault.__name__, True), (tfig4.__name__, True),
                     (tt2.__name__, True), (tsim.__name__, True),
                     (tkernel.__name__, None), (twire.__name__, True)]
    assert "all benchmark sections completed" in capsys.readouterr().out
