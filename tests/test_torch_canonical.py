"""The main path's acceptance test: the port's canonical convergence runs
against the committed ``CONV_reference.json``.

``repro_torch.obs.report.run_canonical`` runs each of the four
``CANONICAL`` scenarios on the CPU with the JAX package's own data draws
(``repro.data.logistic.generate(PRNGKey(CANONICAL_SEED))`` and its
``solve_global``), passed in as ``problem=``: the port cannot reproduce
``jax.random`` streams, and the reference curves were drawn from them.

Tolerances are the reference gate's own (``repro.obs.report.gate_records``
with the file's ``tol``/``tol_bytes``): e_K at most 1.25× the reference
at every sampled round, the final ``bytes_up`` within ±1%.  The port's
``gate_records`` must return the same messages as the reference's on the
same records, also on a copy with e_K raised 30%, which must fail.
"""
import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.data import logistic as jl
from repro.obs import report as jrep
from repro_torch import convert
from repro_torch.obs import report as trep

REFERENCE = json.loads((Path(__file__).resolve().parents[1]
                        / "CONV_reference.json").read_text())


def _jax_problem(name):
    cfg = jrep.CANONICAL[name]
    n, dim, m = cfg.get("n_agents", 100), cfg.get("dim", 32), cfg.get("m", 40)
    data, _ = jl.generate(jax.random.PRNGKey(jrep.CANONICAL_SEED),
                          n_agents=n, m=m, dim=dim)
    x_star = np.array(jl.solve_global(data, eps=50.0))
    data = convert.data_from_numpy({k: np.asarray(v) for k, v in data.items()},
                                   device="cpu")
    return data, x_star


def test_canonical_configs_are_the_references():
    assert trep.CANONICAL == jrep.CANONICAL
    assert trep.CANONICAL_SEED == jrep.CANONICAL_SEED
    assert (trep.DEFAULT_TOL, trep.DEFAULT_TOL_BYTES) == (jrep.DEFAULT_TOL,
                                                          jrep.DEFAULT_TOL_BYTES)


@pytest.mark.parametrize("name", list(jrep.CANONICAL))
def test_port_passes_the_reference_gate(name):
    records = trep.run_canonical(name, problem=_jax_problem(name), device="cpu")
    assert jrep.gate_records(name, records, REFERENCE) == []
    assert trep.gate_records(name, records, REFERENCE) == []
    bytes_up = trep.extract_series(records)["bytes_up"]["values"][-1]
    assert bytes_up == REFERENCE["scenarios"][name]["bytes_up"]

    worse = copy.deepcopy(records)
    for r in worse:
        if r.get("kind") == "series" and r["name"] == "e_K":
            r["value"] *= 1.3
    bad = jrep.gate_records(name, worse, REFERENCE)
    assert bad and trep.gate_records(name, worse, REFERENCE) == bad


def test_gate_messages_match_on_missing_and_unknown():
    assert (trep.gate_records("nope", [], REFERENCE)
            == jrep.gate_records("nope", [], REFERENCE))
    assert (trep.gate_records("sync-lossless", [], REFERENCE)
            == jrep.gate_records("sync-lossless", [], REFERENCE))
    v1 = [{"kind": "fl_round", "round": 0, "error": 1.0, "bytes_up": 5.0}]
    assert trep.extract_series(v1) == {"e_K": {"steps": [0], "values": [1.0]},
                                       "bytes_up": {"steps": [0], "values": [5.0]}}


def test_chaos_curve_on_the_ports_draw(monkeypatch):
    """``sync-mega-chaos`` on the port's own draw, the one ``chip_smoke.py``
    runs on the card: the reference's ``run_canonical``, fed that draw,
    gives the port's e_K curve (rtol 1e-4), and on this draw the curve
    dips below its start and then ends above it.  So "e_K ends below its
    start" is not a property the code owes on this draw."""
    import jax.numpy as jnp

    from repro_torch.data import logistic as tl

    name = "sync-mega-chaos"
    cfg = jrep.CANONICAL[name]
    data, _ = tl.generate(trep.CANONICAL_SEED, n_agents=cfg["n_agents"],
                          m=cfg["m"], dim=cfg["dim"], device="cpu")
    ours = trep.extract_series(trep.run_canonical(name, device="cpu"))
    drawn = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    monkeypatch.setattr(jl, "generate", lambda key, **kw: (drawn, None))
    theirs = trep.extract_series(jrep.run_canonical(name))
    assert ours["bytes_up"] == theirs["bytes_up"]
    e_ours, e_theirs = ours["e_K"]["values"], theirs["e_K"]["values"]
    np.testing.assert_allclose(e_ours, e_theirs, rtol=1e-4)
    assert min(e_theirs[1:]) < e_theirs[0] < e_theirs[-1]
