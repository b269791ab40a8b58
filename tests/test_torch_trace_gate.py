"""The harness's tracing-overhead gate on a fake clock, held against the
reference's.

``bench_trace_overhead`` of the port (``repro_torch.bench.sim_scale``)
and of the JAX package (``benchmarks/sim_scale.py``) runs on a fake
engine whose trajectories advance a fake ``perf_counter`` by set times, a
traced one by more, so its decision is deterministic: the least of 9
interleaved runs of each side, one re-measure when that breaches 1.05
with the better ratio kept, and a raise from 1000 satellites on.  Each
case runs on both packages, and the two gates must return the same dict,
raise alike and time the same number of trajectories.  No real time is
measured.
"""
import re
import types

import numpy as np
import pytest

import benchmarks.sim_scale as ref_sim_scale
import repro.bench.timing as ref_timing
from repro import obs as ref_obs
from repro_torch import obs
from repro_torch.bench import sim_scale, timing
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

BOUND = 1.05
# the warm-up trajectory, then per estimate time_pair's untimed pair and 9 timed pairs
ONE_ESTIMATE = 1 + 2 + 2 * 9
TWO_ESTIMATES = ONE_ESTIMATE + 2 + 2 * 9

# (sim_scale module, timing module, obs package) of each side
PACKAGES = {"port": (sim_scale, timing, obs),
            "reference": (ref_sim_scale, ref_timing, ref_obs)}


class _FakeHost:
    """A clock that moves only when a fake trajectory runs: trajectory k
    takes ``time_of(k, traced)`` seconds, traced when ``pkg_obs`` has an
    active tracer."""

    def __init__(self, time_of, pkg_obs):
        self.now = 0.0
        self.time_of = time_of
        self.obs = pkg_obs
        self.trajectories = 0

    def perf_counter(self):
        return self.now

    def engine(self, scenario, seed=0):
        host = self

        class FakeEngine:
            def run_round(self, t, msg):
                return types.SimpleNamespace(duration=1.0)

            def run_async(self, t0, msg, n_deliveries):
                trc = host.obs.active()
                host.now += host.time_of(host.trajectories, trc is not None)
                host.trajectories += 1
                for _ in range(n_deliveries if trc is not None else 0):
                    trc.event("delivery")
        return FakeEngine()


def _steady(seed, cost):
    """~60 ms a trajectory with a 0.5% jitter; tracing costs ``cost``."""
    jitter = 1 + 0.005 * np.random.default_rng(seed).standard_normal(100)
    return lambda k, traced: 0.060 * jitter[k] * (1 + cost if traced else 1)


def _better_second(k, traced):
    """The first estimate's traced runs are 10% slower, the second's 1%."""
    return 0.060 * (1 + (0.10 if k < ONE_ESTIMATE else 0.01) * traced)


def _gate(monkeypatch, pkg, time_of, n_sats=1000):
    mod, tmod, pkg_obs = PACKAGES[pkg]
    host = _FakeHost(time_of, pkg_obs)
    monkeypatch.setattr(tmod, "time", types.SimpleNamespace(perf_counter=host.perf_counter))
    monkeypatch.setattr(mod, "Engine", host.engine)
    return host, lambda: mod.bench_trace_overhead(n_sats)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_passes_at_a_small_tracing_cost_from_one_estimate(monkeypatch, pkg, seed):
    host, gate = _gate(monkeypatch, pkg, _steady(seed, 0.02))
    r = gate()
    assert r["overhead"] < BOUND
    assert r["overhead"] == r["s_enabled"] / r["s_disabled"]
    assert r["events"] == 100 and r["n_sats"] == 1000
    assert host.trajectories == ONE_ESTIMATE


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_raises_at_a_real_cost_after_one_re_measure(monkeypatch, pkg, seed):
    host, gate = _gate(monkeypatch, pkg, _steady(seed, 0.10))
    with pytest.raises(AssertionError, match="breaches the <5% budget"):
        gate()
    assert host.trajectories == TWO_ESTIMATES


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_gate_keeps_the_better_of_two_estimates(monkeypatch, pkg):
    host, gate = _gate(monkeypatch, pkg, _better_second)
    r = gate()
    assert r["overhead"] == pytest.approx(1.01)
    assert host.trajectories == TWO_ESTIMATES


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_gate_does_not_raise_below_1000_satellites(monkeypatch, pkg):
    host, gate = _gate(monkeypatch, pkg, _steady(0, 0.10), n_sats=100)
    r = gate()
    assert r["overhead"] >= BOUND and r["n_sats"] == 100
    assert host.trajectories == TWO_ESTIMATES


def _outcome(monkeypatch, pkg, time_of, n_sats):
    """What one package's gate did on a fake host: ("pass", its dict) or
    ("raise", the ratio in its message), and the trajectories it ran."""
    host, gate = _gate(monkeypatch, pkg, time_of, n_sats)
    try:
        result = ("pass", gate())
    except AssertionError as e:
        result = ("raise", float(re.search(r"tracing overhead ([0-9.]+)x", str(e)).group(1)))
    return result, host.trajectories


@pytest.mark.parametrize("time_of, n_sats", [
    (_steady(0, 0.0), 1000), (_steady(1, 0.02), 1000), (_steady(0, 0.06), 1000),
    (_steady(1, 0.10), 1000), (_better_second, 1000), (_steady(0, 0.10), 100),
], ids=["0pct", "2pct", "6pct", "10pct", "better-second", "10pct-100sats"])
def test_gate_matches_the_reference(monkeypatch, time_of, n_sats):
    port = _outcome(monkeypatch, "port", time_of, n_sats)
    ref = _outcome(monkeypatch, "reference", time_of, n_sats)
    assert port == ref
