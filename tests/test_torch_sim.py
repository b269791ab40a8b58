"""The port's copy of the simulator stack against the JAX package's.

``repro_torch.sim`` (with its ``constellation``, ``channel``, ``faults``
and ``obs`` copies) is numpy host code copied from ``repro``; these tests
catch drift between the two.  Both engines run the same scenario from the
same seed, sync rounds and an async delivery stream, on the fast core and
on the heapq oracle.

Tolerance: none.  ``RoundResult.to_dict()``, ``Delivery.to_dict()`` and
the contact-window cohorts must be equal field for field: the engine is
deterministic numpy arithmetic, the same on both sides.
"""
import numpy as np
import pytest

from repro import sim as jsim
from repro.constellation.links import message_bytes
from repro_torch import sim as tsim
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

MSG = message_bytes(10_000, 10.0)
SCENARIOS = ["walker-kiruna", "dual-station", "lossy-uplink",
             "plane-agg-walker", "chaos-direct", "mega-1000-lossy"]


def _cohorts(res):
    return [(c.station, c.window, list(c.sats), [d.to_dict() for d in c.deliveries])
            for c in res.cohorts()]


def _sync(pkg, name, rounds, fast=True):
    eng = pkg.Engine(pkg.get_scenario(name), seed=0, fast=fast)
    t, out = 0.0, []
    for _ in range(rounds):
        res = eng.run_round(t, MSG)
        t += res.duration
        out.append(res)
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_sync_rounds_equal(name):
    rounds = 2 if name.startswith("mega") else 3
    ours, theirs = _sync(tsim, name, rounds), _sync(jsim, name, rounds)
    for a, b in zip(ours, theirs):
        assert a.to_dict() == b.to_dict()
        assert _cohorts(a) == _cohorts(b)
        np.testing.assert_array_equal(a.mask, b.mask)
    assert sum(len(r.deliveries) for r in ours) > 0


@pytest.mark.parametrize("name", ["walker-kiruna", "dual-station",
                                  "lossy-uplink", "chaos-direct"])
def test_async_stream_equal(name):
    streams = []
    for pkg in (tsim, jsim):
        eng = pkg.Engine(pkg.get_scenario(name), seed=0)
        streams.append([d.to_dict() for d in eng.run_async(0.0, MSG, n_deliveries=40)])
    assert streams[0] == streams[1]
    assert len(streams[0]) >= 40


def test_heapq_oracle_equal():
    ours = _sync(tsim, "lossy-uplink", 2, fast=False)
    theirs = _sync(jsim, "lossy-uplink", 2, fast=False)
    assert [r.to_dict() for r in ours] == [r.to_dict() for r in theirs]
    # and the port's oracle equals the port's fast core
    assert [r.to_dict() for r in ours] == [
        r.to_dict() for r in _sync(tsim, "lossy-uplink", 2)]


def test_same_scenario_registry():
    assert tsim.names() == jsim.names()
    for name in tsim.names():
        assert repr(tsim.get_scenario(name)) == repr(jsim.get_scenario(name))
