"""CLI: summarize, diff, check, export, and cross-run-track obs traces.

The port's ``python -m repro_torch.obs``, with the subcommands and exit
codes of the JAX package's ``python -m repro.obs``:

    python -m repro_torch.obs summarize TRACE.jsonl [--json]
    python -m repro_torch.obs diff FAST.jsonl ORACLE.jsonl [--kinds delivery round]
    python -m repro_torch.obs check TRACE.jsonl [MORE.jsonl ...]
    python -m repro_torch.obs chrome TRACE.jsonl -o TRACE.perfetto.json
    python -m repro_torch.obs ingest TRACE.jsonl [--ledger runs/ledger.jsonl]
    python -m repro_torch.obs report [--ledger runs/ledger.jsonl] [--frontier]
    python -m repro_torch.obs watch TRACE.jsonl [--total N] [--max-wait S]
    python -m repro_torch.obs convgate [--reference CONV_reference.json]
    python -m repro_torch.obs convgate --update    # -> results/torch/CONV_reference.json
    python -m repro_torch.obs prof TRACE.jsonl [--flame F] [--min-attribution Q]
    python -m repro_torch.obs perfdiff A.jsonl B.jsonl [--top N] [--tol T]
    python -m repro_torch.obs bench-history [BENCH_*.json ...] [--history H]
    python -m repro_torch.obs --check TRACE.jsonl          # alias for `check`

All subcommands read ``.gz`` traces transparently.  ``diff`` exits 1 on
the first divergence (printing the record index and field delta),
``check`` exits 1 on any violated invariant, ``convgate`` exits 1 when a
convergence curve degrades past the committed reference tolerance
(naming the scenario, round, and metric) and 2 when a trace names no
canonical scenario.  ``convgate`` without traces runs the canonical
scenarios on the card.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import prof as _prof
from .chrome import write_chrome_trace
from .ledger import DEFAULT_LEDGER, ingest, load_ledger
from .report import (REFERENCE_PATH, UPDATE_PATH, convgate, render_frontier,
                     render_report, update_reference, watch)
from .summary import DIFF_KINDS, check, diff, summarize, summarize_dict
from .trace import load


def _parse_meta(pairs) -> dict:
    out = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--meta wants key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--check":       # `--check F` alias of `check F`
        argv[0] = "check"
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="per-round summary table")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summary (what ingest/report "
                        "consume) instead of the table")

    p = sub.add_parser("diff", help="localize the first divergence "
                                    "between two traces")
    p.add_argument("trace_a")
    p.add_argument("trace_b")
    p.add_argument("--kinds", nargs="*", default=None,
                   help=f"event kinds to compare (default: "
                        f"{' '.join(DIFF_KINDS)})")

    p = sub.add_parser("check", help="assert trace invariants "
                                     "(bytes conservation, ordering)")
    p.add_argument("traces", nargs="+")

    p = sub.add_parser("chrome", help="export a Perfetto-loadable "
                                      "Chrome trace")
    p.add_argument("trace")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default: <trace>.perfetto.json)")

    p = sub.add_parser("ingest", help="fold traces into the run ledger")
    p.add_argument("traces", nargs="+")
    p.add_argument("--ledger", default=DEFAULT_LEDGER)
    p.add_argument("--sha", default=None,
                   help="git sha override (default: REPRO_GIT_SHA env "
                        "or `git rev-parse --short HEAD`)")
    p.add_argument("--meta", nargs="*", default=None, metavar="K=V",
                   help="header-meta overrides, e.g. scenario=mega-1000")

    p = sub.add_parser("report", help="cross-run comparison table + "
                                      "bytes-vs-e_K frontier")
    p.add_argument("--ledger", default=DEFAULT_LEDGER)
    p.add_argument("--frontier", action="store_true",
                   help="only the bytes-to-ground vs e_K frontier")

    p = sub.add_parser("watch", help="tail a live trace (per-round "
                                     "table, rate, ETA)")
    p.add_argument("trace")
    p.add_argument("--total", type=int, default=None,
                   help="expected total rounds (enables ETA)")
    p.add_argument("--interval", type=float, default=0.5)
    p.add_argument("--max-wait", type=float, default=None,
                   help="stop after this many idle seconds")
    p.add_argument("--no-follow", action="store_true",
                   help="one pass over what exists now, then exit")

    p = sub.add_parser("convgate", help="CI convergence gate vs the "
                                        "committed reference curves")
    p.add_argument("traces", nargs="*",
                   help="existing traces to gate (default: run the "
                        "canonical scenarios fresh)")
    p.add_argument("--reference", default=None,
                   help=f"reference curves (gating: default {REFERENCE_PATH}; "
                        f"--update: default {UPDATE_PATH})")
    p.add_argument("--scenario", default=None,
                   help="canonical scenario name for the given traces "
                        "(default: from each trace's header meta)")
    p.add_argument("--ledger", default=None,
                   help="also ingest fresh canonical runs here")
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--tol-bytes", type=float, default=None)
    p.add_argument("--update", action="store_true",
                   help="re-run the canonical scenarios and REWRITE the "
                        "reference file instead of gating (the port's own "
                        "file unless --reference names another)")

    p = sub.add_parser("prof", help="phase-attribution profile of a "
                                    "trace's phase records")
    p.add_argument("trace")
    p.add_argument("--flame", default=None, metavar="FILE",
                   help="also write folded stacks (speedscope/"
                        "flamegraph.pl input) here")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="also write the table here")
    p.add_argument("--min-attribution", type=float, default=None,
                   metavar="FRAC",
                   help="exit 1 if less than this fraction of wall time "
                        "is attributed (CI gate, e.g. 0.9)")

    p = sub.add_parser("perfdiff", help="diff two phase profiles and "
                                        "name the top regressed phases")
    p.add_argument("trace_a", help="reference trace")
    p.add_argument("trace_b", help="fresh trace")
    p.add_argument("--top", type=int, default=8)
    p.add_argument("--tol", type=float, default=0.2,
                   help="per-phase regression tolerance (default 0.2)")

    p = sub.add_parser("bench-history",
                       help="ingest BENCH_*.json emissions into the "
                            "append-only history and render per-metric "
                            "trajectories with regression onsets")
    p.add_argument("bench_json", nargs="*",
                   help="BENCH_*.json files to ingest (none: render "
                        "the existing history)")
    p.add_argument("--history", default=_prof.DEFAULT_HISTORY)
    p.add_argument("--tol", type=float, default=0.2)
    p.add_argument("--sha", default=None,
                   help="git sha override for the ingested entries")

    args = ap.parse_args(argv)

    if args.cmd == "summarize":
        records = load(args.trace)
        if args.json:
            print(json.dumps(summarize_dict(records), sort_keys=True))
        else:
            print(summarize(records))
        return 0
    if args.cmd == "diff":
        equal, report = diff(load(args.trace_a), load(args.trace_b),
                             kinds=args.kinds)
        print(report)
        return 0 if equal else 1
    if args.cmd == "check":
        rc = 0
        for path in args.traces:
            bad = check(load(path))
            if bad:
                rc = 1
                print(f"{path}: {len(bad)} invariant violation(s)")
                for msg in bad:
                    print(f"  {msg}")
            else:
                print(f"{path}: all invariants hold")
        return rc
    if args.cmd == "chrome":
        out = args.out or args.trace + ".perfetto.json"
        write_chrome_trace(load(args.trace), out)
        print(f"wrote {out} — open in https://ui.perfetto.dev")
        return 0
    if args.cmd == "ingest":
        meta = _parse_meta(args.meta)
        for path in args.traces:
            entry, added = ingest(path, args.ledger, sha=args.sha, **meta)
            print(f"{path}: {'ingested' if added else 'already present'} "
                  f"as {entry['run_id']} "
                  f"(scenario={entry['scenario']}, "
                  f"e_K={entry['final'].get('e_K')})")
        return 0
    if args.cmd == "report":
        entries = load_ledger(args.ledger)
        if args.frontier:
            print(render_frontier(entries))
        else:
            print(render_report(entries))
            print()
            print("bytes-to-ground vs e_K frontier (* = Pareto):")
            print(render_frontier(entries))
        return 0
    if args.cmd == "watch":
        return watch(args.trace, total=args.total, interval=args.interval,
                     follow=not args.no_follow, max_wait=args.max_wait)
    if args.cmd == "convgate":
        if args.update:
            path = args.reference or UPDATE_PATH
            doc = update_reference(path)
            print(f"wrote {path}: "
                  f"{sorted(doc['scenarios'])} (tol={doc['tol']})")
            return 0
        return convgate(args.reference or REFERENCE_PATH,
                        traces=args.traces or None,
                        scenario=args.scenario, ledger_path=args.ledger,
                        tol=args.tol, tol_bytes=args.tol_bytes)
    if args.cmd == "prof":
        profile = _prof.collect(load(args.trace))
        table = _prof.render_profile(profile, title=args.trace)
        print(table)
        if args.out:
            with open(args.out, "w") as f:
                f.write(table + "\n")
            print(f"wrote {args.out}")
        if args.flame:
            with open(args.flame, "w") as f:
                f.write(_prof.folded(profile))
            print(f"wrote {args.flame} (folded stacks — load in "
                  f"https://speedscope.app)")
        if args.min_attribution is not None:
            _, frac = _prof.attribution(profile)
            if frac < args.min_attribution:
                print(f"ATTRIBUTION GATE FAILED: {frac:.1%} < "
                      f"{args.min_attribution:.1%} of wall attributed")
                return 1
        return 0
    if args.cmd == "perfdiff":
        d = _prof.perfdiff(load(args.trace_a), load(args.trace_b),
                           tol=args.tol, top=args.top)
        print(_prof.render_perfdiff(d, top=args.top))
        return 0
    if args.cmd == "bench-history":
        for path in args.bench_json:
            entry, added = _prof.ingest_bench(path, args.history,
                                              sha=args.sha)
            print(f"{path}: {'ingested' if added else 'already present'} "
                  f"as {entry['group']}/{entry['bench_id']}")
        print(_prof.render_history(_prof.load_history(args.history),
                                   tol=args.tol))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
