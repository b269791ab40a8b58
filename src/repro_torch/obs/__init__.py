"""Observability for the port: structured tracing, metrics and the phase
profiler, copied from the JAX package's ``obs`` (``trace``, ``metrics``,
``prof``).

Disabled (the default) the only cost is a module attribute read per
round.  Enabled, the engine, the channel and
:class:`~repro_torch.core.fedlt_sat.SpaceRunner` emit typed JSONL records
with the JAX package's schema::

    from repro_torch import obs
    with obs.tracing("run.jsonl", scenario="walker-kiruna") as trc:
        runner.run(alg, state, data, n_rounds=50, seed=0)
    records = obs.load("run.jsonl")

:mod:`repro_torch.obs.summary` summarizes, diffs and checks a trace
(``obs.render_rounds(records)`` prints the per-round table), as the JAX
package's does, string for string.  The JAX package's Chrome export, run
ledger, report CLI and convergence gate are not ported yet;
:mod:`repro_torch.obs.report` holds the canonical convergence scenarios
and ``gate_records``.
"""
from .metrics import Counter, Histogram, Metrics
from .prof import PhaseAcc
from .summary import (check, diff, extract_series, render_rounds, summarize,
                      summarize_dict)
from .trace import Tracer, active, disable, enable, load, tracing

__all__ = [
    "Tracer", "active", "enable", "disable", "tracing", "load",
    "Metrics", "Counter", "Histogram", "PhaseAcc",
    "summarize", "summarize_dict", "extract_series", "render_rounds",
    "diff", "check",
]
