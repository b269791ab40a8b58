"""``repro_torch.obs.summary`` against the JAX package's ``repro.obs.summary``.

Both packages' functions read the same records: the traces of a few port
runs through ``Experiment`` on the CPU (sync with a lossy channel, async,
and the engine alone), and the committed ``tests/data/*.jsonl``.  Every
rendered string, summary dict, diff report and check list must be equal,
character for character.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import summary as js
from repro_torch import api as tapi
from repro_torch import channel as tch
from repro_torch import obs as tobs
from repro_torch.core import baselines as tb
from repro_torch.core import compression as tc
from repro_torch.core import error_feedback as te
from repro_torch.core import fedlt as tf
from repro_torch.data import logistic as tl
from repro_torch.obs import summary as ts
from repro_torch.sim import Engine, get_scenario
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

DATA = Path(__file__).resolve().parent / "data"
N, M, D = 100, 8, 6


def _experiment_records(alg_name, scenario, **kw):
    data, _ = tl.generate(3, n_agents=N, m=M, dim=D, device="cpu")
    x_star = tl.solve_global(data)
    q = tc.UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    loss = tl.make_local_loss(50.0, N)
    if alg_name == "fedlt":
        alg = tf.FedLT(loss=loss, uplink=te.EFChannel(q), downlink=te.EFChannel(q),
                       n_epochs=3, gamma=0.005, rho=20.0)
    else:
        alg = tb.FedAvg(loss=loss, uplink=te.EFChannel(q), downlink=te.EFChannel(q),
                        n_epochs=3, gamma=0.05)
    exp = tapi.Experiment.from_scenario(scenario, algorithm=alg, compressor=q,
                                        device="cpu", **kw)
    res = exp.run(exp.init(torch.zeros(D), N), data, 6, 1, log_every=2,
                  trace=True, error_fn=lambda s: tf.optimality_error(s.x, x_star))
    return res.records


def _engine_records():
    eng = Engine(get_scenario("lossy-uplink"), seed=0)
    with tobs.tracing(scenario="lossy-uplink") as trc:
        t = 0.0
        for _ in range(3):
            t += eng.run_round(t, 2048.0).duration
        eng.run_async(t, 2048.0, n_deliveries=20)
        return trc.records()


TRACES = {
    "fedavg-lossy": lambda: _experiment_records(
        "fedavg", "lossy-uplink", measure="cohort",
        channel=tch.ChannelModel(loss=0.3, arq=tch.SelectiveRepeatARQ(
            seg_bytes=4096, max_rounds=1))),
    "fedlt-async": lambda: _experiment_records(
        "fedlt", "dual-station", mode="async", buffer_size=10),
    "engine-only": _engine_records,
}
TRACES.update({p.name: (lambda p=p: tobs.load(str(p)))
               for p in sorted(DATA.glob("*.jsonl"))})


@pytest.fixture(scope="module")
def traces():
    return {name: make() for name, make in TRACES.items()}


def test_the_traces_cover_every_table(traces):
    kinds = {name: {r.get("kind") for r in recs} for name, recs in traces.items()}
    assert "fl_round" in kinds["fedavg-lossy"] and "delivery" in kinds["fedavg-lossy"]
    assert "async_run" in kinds["engine-only"] and "fl_round" not in kinds["engine-only"]
    assert "series" not in kinds["trace_schema_v1.jsonl"]      # the v1 fallback
    assert any(not r["delivered"] for r in traces["fedavg-lossy"]
               if r.get("kind") == "delivery")


@pytest.mark.parametrize("name", list(TRACES))
def test_render_and_summarize_equal_the_reference(traces, name):
    recs = traces[name]
    assert ts.render_rounds(recs) == js.render_rounds(recs)
    assert ts.summarize(recs) == js.summarize(recs)
    assert ts.summarize_dict(recs) == js.summarize_dict(recs)
    assert ts.extract_series(recs) == js.extract_series(recs)
    assert ts.check(recs) == js.check(recs)
    fl = [r for r in recs if r.get("kind") == "fl_round"]
    for r in fl:
        assert ts.fl_row(r) == js.fl_row(r)
    assert ts.of_kind(recs, "delivery", "round") == js.of_kind(recs, "delivery", "round")
    assert (ts.FL_HEADER, ts.ENG_HEADER, ts.DIFF_KINDS, ts.DIFF_IGNORE) == \
        (js.FL_HEADER, js.ENG_HEADER, js.DIFF_KINDS, js.DIFF_IGNORE)


@pytest.mark.parametrize("name", list(TRACES))
def test_diff_equals_the_reference(traces, name):
    recs = traces[name]
    assert ts.diff(recs, recs) == js.diff(recs, recs)
    assert ts.diff(recs, recs)[0]
    other = copy.deepcopy(recs)
    hit = [r for r in other if r.get("kind") in ts.DIFF_KINDS]
    if hit:
        hit[len(hit) // 2]["t_done" if "t_done" in hit[len(hit) // 2] else "kind"] = 1.5
    assert ts.diff(recs, other) == js.diff(recs, other)
    assert ts.diff(recs, other[:-3]) == js.diff(recs, other[:-3])
    kinds = ("delivery",)
    assert ts.diff(recs, other, kinds=kinds) == js.diff(recs, other, kinds=kinds)


def test_check_finds_what_the_reference_finds(traces):
    recs = copy.deepcopy(traces["engine-only"])
    rounds = [r for r in recs if r.get("kind") == "round"]
    rounds[0]["bytes_air"] += 1.0
    rounds[1]["n_delivered"] += 1
    bad = ts.check(recs)
    assert bad == js.check(recs) and len(bad) >= 2


def test_obs_exports_the_summary():
    for name in ("summarize", "summarize_dict", "extract_series", "render_rounds",
                 "diff", "check"):
        assert getattr(tobs, name) is getattr(ts, name)
        assert name in tobs.__all__
    assert tobs.render_rounds([]) == jobs.render_rounds([]) == "(no rounds recorded)"
    np.testing.assert_equal(ts.summarize_dict([]), js.summarize_dict([]))
