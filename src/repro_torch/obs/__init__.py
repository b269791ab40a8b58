"""Observability for the port: structured tracing, metrics, the run
ledger, reports and the phase profiler, copied from the JAX package's
``obs`` with the same records, entries and rendered text.

Disabled (the default) the only cost is a module attribute read per
round.  Enabled, the engine, the channel and
:class:`~repro_torch.core.fedlt_sat.SpaceRunner` emit typed JSONL records
with the JAX package's schema::

    from repro_torch import obs
    with obs.tracing("run.jsonl", scenario="walker-kiruna") as trc:
        runner.run(alg, state, data, n_rounds=50, seed=0)
    # then:  python -m repro_torch.obs summarize run.jsonl [--json]
    #        python -m repro_torch.obs ingest run.jsonl --ledger runs/ledger.jsonl
    #        python -m repro_torch.obs report --ledger runs/ledger.jsonl
    #        python -m repro_torch.obs watch run.jsonl --total 50
    #        python -m repro_torch.obs convgate run.jsonl
    #        python -m repro_torch.obs check run.jsonl
    #        python -m repro_torch.obs chrome run.jsonl -o run.perfetto.json

* :mod:`~repro_torch.obs.summary`: summarize, diff and check a trace;
* :mod:`~repro_torch.obs.ledger` / :mod:`~repro_torch.obs.report`: the
  append-only run ledger keyed by content-hash run ids, the cross-run
  tables, the bytes-to-ground vs e_K frontier, ``watch`` and the
  ``convgate`` convergence gate over the canonical scenarios;
* :mod:`~repro_torch.obs.chrome`: Chrome/Perfetto export;
* :mod:`~repro_torch.obs.prof`: phase attribution, ``perfdiff`` and the
  ``BENCH_*.json`` history.
"""
from .chrome import chrome_trace, write_chrome_trace
from .ledger import ingest, load_ledger
from .metrics import Counter, Histogram, Metrics
from .prof import (PhaseAcc, attribution, collect, folded, ingest_bench,
                   perfdiff, render_history, render_perfdiff,
                   render_profile)
from .report import convgate, render_frontier, render_report, watch
from .summary import (check, diff, extract_series, render_rounds, summarize,
                      summarize_dict)
from .trace import Tracer, active, disable, enable, load, tracing

__all__ = [
    "Tracer", "active", "enable", "disable", "tracing", "load",
    "Metrics", "Counter", "Histogram",
    "summarize", "summarize_dict", "extract_series", "render_rounds",
    "diff", "check",
    "ingest", "load_ledger", "render_report", "render_frontier",
    "watch", "convgate",
    "chrome_trace", "write_chrome_trace",
    "PhaseAcc", "collect", "render_profile", "folded", "attribution",
    "perfdiff", "render_perfdiff", "ingest_bench", "render_history",
]
