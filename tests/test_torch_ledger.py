"""The port's run ledger, reports, Chrome export, BENCH history and
``python -m repro_torch.obs`` against the JAX package's ``repro.obs``.

Both packages read the same inputs: the traces of small port runs through
``Experiment`` on the CPU (data from numpy draws of one seed), ledger
entries built from them, the committed ``BENCH_*.json`` files, and a
trace of the canonical ``sync-lossless`` scenario run on the reference's
own problem.  Entries, run ids, rendered text, Chrome dicts, BENCH
history lines, the CLI's output and its exit codes must be equal,
character for character.  ``watch`` prints rates from the host clock, so
both packages read the same stand-in clock.
"""
import copy
import gzip
import io
import json
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import logistic as jl
from repro.obs import __main__ as jcli
from repro.obs import chrome as jchrome
from repro.obs import ledger as jledger
from repro.obs import prof as jprof
from repro.obs import report as jrep
from repro_torch import api as tapi
from repro_torch import channel as tch
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.core import compression as tc
from repro_torch.core import error_feedback as te
from repro_torch.core import fedlt as tf
from repro_torch.data import logistic as tl
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import chrome as tchrome
from repro_torch.obs import ledger as tledger
from repro_torch.obs import prof as tprof
from repro_torch.obs import report as trep
from repro_torch.sim import Engine, get_scenario

ROOT = Path(__file__).resolve().parents[1]
N, M, D = 100, 8, 6
SHA = "0123abcd"


@pytest.fixture(autouse=True)
def fixed_sha(monkeypatch):
    monkeypatch.setenv("REPRO_GIT_SHA", SHA)


def _problem():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((N, M, D)).astype(np.float32)
    b = np.sign(a @ rng.standard_normal(D).astype(np.float32)).astype(np.float32)
    data = convert.data_from_numpy({"a": a, "b": b}, device="cpu")
    return data, tl.solve_global(data)


def _experiment(scenario="lossy-uplink", loss=None, **kw):
    q = tc.UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    alg = tf.FedLT(loss=tl.make_local_loss(50.0, N), uplink=te.EFChannel(q),
                   downlink=te.EFChannel(q), n_epochs=3, gamma=0.005, rho=20.0)
    ch = None if loss is None else tch.ChannelModel(
        loss=loss, arq=tch.SelectiveRepeatARQ(seg_bytes=4096, max_rounds=1))
    return tapi.Experiment(scenario, alg, compressor=q, channel=ch,
                           device="cpu", **kw)


def _run(exp, rounds=6, **kw):
    data, x_star = _problem()
    return exp.run(exp.init(torch.zeros(D), N), data, rounds, 1, log_every=2,
                   error_fn=lambda s: float(tf.optimality_error(s.x, x_star)), **kw)


@pytest.fixture(scope="module")
def runs():
    """Traced port runs: a lossy sweep's two arms, a plane topology, an
    async run; their records and a trace file of the first."""
    out = {}
    for loss in (0.0, 0.3):
        for arm, robust in (("EF (loss-robust)", True), ("EF (naive)", False)):
            exp = _experiment(loss=loss, loss_robust=robust,
                              meta=dict(arm=arm, loss_rate=loss, rounds=6, seed=0))
            out[f"{arm}@{loss}"] = _run(exp, trace=True).records
    out["plane"] = _run(_experiment("plane-agg-walker", meta=dict(arm="plane")),
                        trace=True).records
    out["async"] = _run(_experiment("dual-station", mode="async", buffer_size=10),
                        trace=True).records
    return out


@pytest.fixture(scope="module")
def entries(runs):
    ents = [tledger.entry_from_records(r) for r in runs.values()]
    # branches the runs do not reach: no e_K, no bytes, a crash-rate row
    bare = copy.deepcopy(ents[0])
    bare["final"].pop("e_K")
    bare["final"]["bytes_up"] = None
    bare["meta"] = {"crash_rate": 0.1, "arm": "naive restart", "quorum": 0.6}
    bare["faults"] = "crash0.1"
    ents.append(bare)
    return ents


def test_entry_and_run_id_equal_the_reference(runs):
    for name, records in runs.items():
        ours = tledger.entry_from_records(records)
        theirs = jledger.entry_from_records(records)
        assert ours == theirs, name
        assert ours["git_sha"] == SHA and len(ours["run_id"]) == 12
        assert tledger.run_id(ours) == jledger.run_id(theirs) == ours["run_id"]
        over = dict(scenario="x", algorithm=None)
        assert tledger.entry_from_records(records, sha="s", **over) == \
            jledger.entry_from_records(records, sha="s", **over)
    assert tledger.git_sha() == jledger.git_sha() == SHA
    assert (tledger.LEDGER_SCHEMA, tledger.DEFAULT_LEDGER) == \
        (jledger.LEDGER_SCHEMA, jledger.DEFAULT_LEDGER)


def test_run_ledger_writes_the_reference_entry(tmp_path):
    path = str(tmp_path / "runs" / "ledger.jsonl")
    res = _run(_experiment(meta=dict(arm="a")), ledger=path)
    assert res.records is not None and res.run_id is not None
    (entry,) = tledger.load_ledger(path)
    assert entry == jledger.entry_from_records(res.records)
    assert entry["run_id"] == res.run_id and entry["scenario"] == "lossy-uplink"
    assert jledger.load_ledger(path) == [entry]
    # ingest is idempotent, in both packages
    assert res.ingest(path) == entry and len(tledger.load_ledger(path)) == 1
    assert jledger.ingest(res.records, path)[1] is False


def test_ingest_is_idempotent_and_reads_gz(runs, tmp_path):
    records = runs["plane"]
    trace = str(tmp_path / "t.jsonl.gz")
    with gzip.open(trace, "wt") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    ours, theirs = str(tmp_path / "ours.jsonl.gz"), str(tmp_path / "theirs.jsonl.gz")
    e1, added1 = tledger.ingest(trace, ours)
    e2, added2 = tledger.ingest(records, ours)
    j1, jadded = jledger.ingest(trace, theirs)
    assert (added1, added2, jadded) == (True, False, True)
    assert e1 == e2 == j1
    assert tledger.load_ledger(ours) == jledger.load_ledger(theirs) == [e1]
    with gzip.open(ours, "rt") as a, gzip.open(theirs, "rt") as b:
        assert a.read() == b.read()
    assert tledger.load_ledger(str(tmp_path / "absent.jsonl")) == []


def test_report_frontier_and_rows_equal_the_reference(entries):
    assert trep.render_report(entries) == jrep.render_report(entries)
    assert trep.render_frontier(entries) == jrep.render_frontier(entries)
    assert trep.frontier_points(entries) == jrep.frontier_points(entries)
    assert any(p["pareto"] for p in trep.frontier_points(entries))
    for rows in ("lossy_ef_rows", "plane_agg_rows", "fault_tolerance_rows"):
        ours = getattr(trep, rows)(entries)
        assert ours == getattr(jrep, rows)(entries) and ours, rows
    assert trep.render_report([]) == jrep.render_report([]) == "(empty ledger)"
    assert trep.render_frontier([]) == jrep.render_frontier([])


def test_chrome_trace_equals_the_reference(runs, tmp_path):
    eng = Engine(get_scenario("plane-agg-walker"))
    with tobs.tracing() as trc:
        t = 0.0
        for _ in range(2):
            t += eng.run_round(t, 2048.0).duration
        engine_records = trc.records()
    records = engine_records + runs["EF (naive)@0.3"]
    kinds = {r.get("kind") for r in records}
    assert {"delivery", "round", "fl_round", "series", "phase",
            "phase_total", "stage"} <= kinds
    ours = tchrome.chrome_trace(records)
    assert ours == jchrome.chrome_trace(records)
    path = tchrome.write_chrome_trace(records, str(tmp_path / "c.json"))
    assert json.loads(Path(path).read_text()) == json.loads(json.dumps(ours))


def _bench_emission(tmp_path, src, factor):
    """A copy of ``src`` whose gated metrics are ``factor`` times worse."""
    doc = json.loads((ROOT / src).read_text())
    for metrics in doc["benchmarks"].values():
        for md in metrics.values():
            if md.get("gate"):
                hib = md.get("higher_is_better", True)
                md["value"] = md["value"] / factor if hib else md["value"] * factor
    out = tmp_path / src
    out.write_text(json.dumps(doc))
    return str(out)


def test_bench_history_equals_the_reference(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    files = [str(ROOT / "BENCH_kernels.json"), str(ROOT / "BENCH_sim.json"),
             _bench_emission(tmp_path / "a", "BENCH_sim.json", 1.5),
             _bench_emission(tmp_path / "b", "BENCH_sim.json", 1.05)]
    ours, theirs = str(tmp_path / "h_ours.jsonl"), str(tmp_path / "h_theirs.jsonl")
    for path in files + files[:1]:
        a = tprof.ingest_bench(path, ours, sha="s1")
        b = jprof.ingest_bench(path, theirs, sha="s1")
        assert a == b
    assert [e["group"] for e in tprof.load_history(ours)] == \
        ["kernels", "sim", "sim", "sim"]
    hist = tprof.load_history(ours)
    assert hist == jprof.load_history(theirs)
    text = tprof.render_history(hist, tol=0.2)
    assert text == jprof.render_history(hist, tol=0.2)
    assert "REGRESSION ONSET" in text
    assert tprof.render_history([]) == jprof.render_history([])
    for vals, hib in (([1.0, 2.0, 1.5, 0.5], True), ([3.0, 2.0, 2.5, 9.0], False),
                      ([1.0, 1.1, 1.05], True)):
        assert tprof._onset(vals, hib, 0.2) == jprof._onset(vals, hib, 0.2)
    assert tprof.bench_id({"a": {"m": {"value": 1}}}) == \
        jprof.bench_id({"a": {"m": {"value": 1}}})


def _write_trace(records, path):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


def test_trace_tail_reads_complete_lines(runs, tmp_path):
    lines = [json.dumps(r) for r in runs["EF (naive)@0.3"][:5]]
    for pkg in (trep, jrep):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        tail = pkg.TraceTail(path)
        assert tail.poll() == []                           # no file yet
        with open(path, "w") as f:
            f.write(lines[0] + "\n" + lines[1][:7])        # a torn last line
        assert tail.poll() == [json.loads(lines[0])]
        with open(path, "a") as f:
            f.write(lines[1][7:] + "\n" + "\n".join(lines[2:]) + "\n")
        assert tail.poll() == [json.loads(x) for x in lines[1:]]
        assert tail.poll() == []
        gz = path + ".gz"
        with gzip.open(gz, "wt") as f:
            f.write("\n".join(lines) + "\n")
        gz_tail = pkg.TraceTail(gz)
        assert len(gz_tail.poll()) == 5 and gz_tail.poll() == []


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize("follow", [False, True])
def test_watch_prints_what_the_reference_prints(runs, tmp_path, monkeypatch, follow):
    records = runs["EF (loss-robust)@0.3"]
    if not follow:              # a live trace: its metrics record not yet written
        records = [r for r in records if r.get("kind") != "metrics"]
    path = _write_trace(records, str(tmp_path / "w.jsonl"))
    outs = []
    for pkg in (trep, jrep):
        monkeypatch.setattr(time, "perf_counter", _Clock())
        buf = io.StringIO()
        assert pkg.watch(path, total=10, interval=0.0, follow=follow,
                         max_wait=1.0, out=buf) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "ETA" in outs[0] and ("trace closed" in outs[0]) == follow


def _cli(pkg_main, argv, capsys):
    rc = pkg_main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def canonical_trace(tmp_path_factory):
    """``sync-lossless`` on the reference's own problem, as a trace file."""
    cfg = jrep.CANONICAL["sync-lossless"]
    data, _ = jl.generate(jax.random.PRNGKey(jrep.CANONICAL_SEED),
                          n_agents=100, m=cfg.get("m", 40), dim=cfg.get("dim", 32))
    x_star = np.array(jl.solve_global(data, eps=50.0))
    data = convert.data_from_numpy({k: np.asarray(v) for k, v in data.items()},
                                   device="cpu")
    records = trep.run_canonical("sync-lossless", problem=(data, x_star),
                                 device="cpu")
    return _write_trace(records, str(tmp_path_factory.mktemp("conv") / "c.jsonl"))


def test_convgate_on_the_references_problem(canonical_trace, tmp_path, capsys):
    """Exit 0 on the canonical run, 1 on a copy whose e_K is doubled, 2 on
    a trace without a scenario, in both packages.  The reference's own
    claim that an EF-disabled lossy run fails the gate
    (``tests/test_obs_ledger.py::test_convgate_fails_on_ef_disabled_lossy``)
    is red in the reference, so no port test copies it; the doubled curve
    stands in for a degraded one."""
    records = tobs.load(canonical_trace)
    worse = copy.deepcopy(records)
    for r in worse:
        if r.get("kind") == "series" and r.get("name") == "e_K":
            r["value"] *= 2.0
    bad = _write_trace(worse, str(tmp_path / "worse.jsonl"))
    nameless = _write_trace(records[1:], str(tmp_path / "nameless.jsonl"))
    ref = str(ROOT / "CONV_reference.json")
    for argv, want in ((["convgate", canonical_trace], 0),
                       (["convgate", bad], 1),
                       (["convgate", canonical_trace, bad], 1),
                       (["convgate", nameless], 2),
                       (["convgate", nameless, "--scenario", "sync-lossless"], 0)):
        argv = argv + ["--reference", ref]
        ours, theirs = _cli(tcli.main, argv, capsys), _cli(jcli.main, argv, capsys)
        assert ours == theirs and ours[0] == want, (argv, ours)
    assert trep.load_reference(ref) == jrep.load_reference(ref)
    assert trep.reference_entry(records, 30) == jrep.reference_entry(records, 30)


def test_update_reference_writes_the_reference_layout(monkeypatch, canonical_trace,
                                                      tmp_path):
    records = tobs.load(canonical_trace)
    monkeypatch.setattr(trep, "run_canonical", lambda name, device=None: records)
    monkeypatch.setattr(jrep, "run_canonical", lambda name: records)
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    trep.update_reference(ours, names=["sync-lossless"], device="cpu")
    jrep.update_reference(theirs, names=["sync-lossless"])
    assert Path(ours).read_text() == Path(theirs).read_text()


def test_cli_update_leaves_the_committed_reference(monkeypatch, canonical_trace,
                                                   tmp_path, capsys):
    """``convgate --update`` without ``--reference`` writes the port's own
    file; the committed CONV_reference.json, which gating reads, stays."""
    records = tobs.load(canonical_trace)
    monkeypatch.setattr(trep, "run_canonical", lambda name, device=None: records)
    monkeypatch.chdir(tmp_path)
    committed = tmp_path / trep.REFERENCE_PATH
    committed.write_text("{}\n")
    rc, out = _cli(tcli.main, ["convgate", "--update"], capsys)
    assert rc == 0 and trep.UPDATE_PATH in out
    assert committed.read_text() == "{}\n"
    doc = trep.load_reference(trep.UPDATE_PATH)
    assert sorted(doc["scenarios"]) == sorted(trep.CANONICAL)


def test_cli_subcommands_match_the_reference(runs, canonical_trace, tmp_path, capsys,
                                             monkeypatch):
    a = _write_trace(runs["EF (loss-robust)@0.3"], str(tmp_path / "a.jsonl"))
    b = _write_trace(runs["EF (naive)@0.0"], str(tmp_path / "b.jsonl"))
    broken = copy.deepcopy(runs["EF (naive)@0.3"])
    for r in broken:
        if r.get("kind") == "delivery":
            r["nbytes_attempted"] = r.get("nbytes_attempted", 0) + 1e6
    c = _write_trace(broken, str(tmp_path / "c.jsonl"))
    chrome_out = str(tmp_path / "a.perfetto.json")
    cases = [
        (["summarize", a], 0), (["summarize", a, "--json"], 0),
        (["diff", a, a], 0), (["diff", a, b], 1),
        (["check", a, b], 0), (["check", c], 1), (["--check", a], 0),
        (["chrome", a, "-o", chrome_out], 0),
        (["prof", a], 0), (["perfdiff", a, b], 0),
        (["watch", a, "--no-follow", "--interval", "0"], 0),
    ]
    for argv, want in cases:
        outs = []
        for main in (tcli.main, jcli.main):
            monkeypatch.setattr(time, "perf_counter", _Clock())
            outs.append(_cli(main, argv, capsys))
        assert outs[0] == outs[1], argv
        assert outs[0][0] == want, (argv, outs[0])
    # ledger subcommands, each package on its own ledger
    for sub in (["ingest", a, b, canonical_trace], ["ingest", a],
                ["report"], ["report", "--frontier"]):
        outs = [_cli(main, sub + ["--ledger", str(tmp_path / name)], capsys)
                for main, name in ((tcli.main, "t.jsonl"), (jcli.main, "j.jsonl"))]
        assert outs[0] == outs[1] and outs[0][0] == 0, sub
    assert "already present" in _cli(tcli.main, ["ingest", a, "--ledger",
                                                  str(tmp_path / "t.jsonl")], capsys)[1]
    hist = []
    for main, name in ((tcli.main, "ht.jsonl"), (jcli.main, "hj.jsonl")):
        hist.append(_cli(main, ["bench-history", str(ROOT / "BENCH_sim.json"),
                                "--history", str(tmp_path / name), "--sha", "s"],
                         capsys))
    assert hist[0] == hist[1] and hist[0][0] == 0
    assert os.path.exists(chrome_out)


def test_launcher_trace_and_ledger_flags_match_the_reference_launcher(tmp_path, capsys,
                                                                      monkeypatch):
    """``repro_torch.launch.train.main`` with ``--smoke --no-compress
    --trace --ledger`` on the CPU, one round: the loss finite, the trace's
    ``loss`` series that loss, the ledger one entry, which ``obs report
    --ledger`` reads; and the trace's record kinds and series names those of
    the JAX launcher's trace under the same flags (the losses differ: the
    packages draw other weights and tokens).  The port's trace also holds
    what its attention's dispatch hook writes, as ``repro.kernels.ops``'
    does for a dispatched kernel: a ``kernel`` record per call (the one
    attention layer's forward and its recompute, per agent) and a
    ``metrics`` record of those dispatches; the JAX package's model attends
    in plain JAX, outside ``ops``, and writes neither."""
    import sys

    from repro.launch import train as jtrain
    from repro.obs import trace as jtrace
    from repro_torch.launch import train as ttrain
    from repro_torch.obs import trace as ttrace
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--rounds", "1", "--agents", "2",
            "--batch", "1", "--seq", "64", "--n-epochs", "1", "--no-compress"]
    paths = {pkg: (str(tmp_path / f"{pkg}.jsonl"), str(tmp_path / f"{pkg}_ledger.jsonl"))
             for pkg in ("port", "ref")}
    run = ttrain.main(argv + ["--trace", paths["port"][0], "--ledger", paths["port"][1]],
                      device="cpu")
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--trace", paths["ref"][0], "--ledger", paths["ref"][1]])
    jtrain.main()
    capsys.readouterr()
    assert len(run.losses) == 1 and np.isfinite(run.losses[0])
    traces = {"port": ttrace.load(paths["port"][0]), "ref": jtrace.load(paths["ref"][0])}
    losses = [r for r in traces["port"] if r["kind"] == "series" and r["name"] == "loss"]
    assert [(r["step"], r["value"]) for r in losses] == [(0, run.losses[0])]
    hook = [r for r in traces["port"] if r["kind"] in ("kernel", "metrics")]
    assert [r.get("name") for r in hook] == ["attention"] * 4 + [None]
    assert hook[-1]["counters"] == {"kernel_dispatches": {
        "cells": {"name=attention": 4.0}, "total": 4.0}} and not hook[-1]["histograms"]
    kinds = {pkg: sorted({r["kind"] for r in recs if r not in hook})
             for pkg, recs in traces.items()}
    names = {pkg: sorted({r["name"] for r in recs if r["kind"] == "series"})
             for pkg, recs in traces.items()}
    assert kinds["port"] == kinds["ref"] and names["port"] == names["ref"] == ["loss"]
    entries = tledger.load_ledger(paths["port"][1])
    assert len(entries) == 1 and len(jledger.load_ledger(paths["ref"][1])) == 1
    rc, text = _cli(tcli.main, ["report", "--ledger", paths["port"][1]], capsys)
    assert rc == 0 and entries[0]["run_id"] in text
