"""Perf-gate comparator: fresh ``BENCH_*.json`` vs committed baselines.

Counterpart of ``repro.bench.compare``, verdict for verdict::

    python -m repro_torch.bench --tiny --emit bench_out/
    python -m repro_torch.bench.compare bench_out [--baseline DIR] [--tol 0.2]

The baseline defaults to :data:`BASELINE_DIR`
(``src/repro_torch/bench/baseline/``), the port's own numbers from a full
run on the card.  The root ``BENCH_*.json`` are the JAX package's CPU
numbers and are never the port's baseline.

For every metric present in BOTH files the comparator reports the
new/baseline ratio; metrics the baseline marks ``gate=True`` FAIL the run
when they regress beyond the tolerance (direction-aware: a
higher-is-better metric must stay ≥ baseline·(1−tol), a lower-is-better
one ≤ baseline·(1+tol)).  Ungated metrics present in only one file are
listed but never fail — a tiny run is a strict subset of a full
baseline.  A GATED baseline metric that the fresh run failed to produce
is itself a failure (the gate must not fail open when a benchmark breaks
or is skipped).  Improvements beyond the tolerance are flagged as
candidates for a baseline refresh (``python -m repro_torch.bench --emit
src/repro_torch/bench/baseline``).

When the gate trips and BOTH directories hold a trace with the same
filename (``TRACE_*.jsonl[.gz]``), the failure report also runs
:func:`repro_torch.obs.prof.perfdiff` over each matching pair so the log
names *which phase* moved, not just that something did.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from typing import Dict, List, Tuple

GROUPS = ("sim", "kernels")

#: the port's committed baselines (a full run on the card)
BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baseline")


@dataclasses.dataclass
class Verdict:
    group: str
    bench: str
    metric: str
    status: str         # "ok" | "regression" | "improved" | "info" | "missing"
    new: float = float("nan")
    base: float = float("nan")

    @property
    def ratio(self) -> float:
        return self.new / self.base if self.base else float("inf")


def bench_path(directory: str, group: str) -> str:
    return os.path.join(directory, f"BENCH_{group}.json")


def load(directory: str, group: str) -> Dict[str, Dict[str, dict]]:
    """{bench: {metric: metric_dict}} from BENCH_<group>.json ({} if absent)."""
    path = bench_path(directory, group)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f).get("benchmarks", {})


def compare_group(new: Dict[str, Dict[str, dict]],
                  base: Dict[str, Dict[str, dict]], group: str,
                  tol: float) -> List[Verdict]:
    verdicts: List[Verdict] = []
    for bench in sorted(set(new) | set(base)):
        n_metrics = new.get(bench, {})
        b_metrics = base.get(bench, {})
        for m in sorted(set(n_metrics) | set(b_metrics)):
            if m not in n_metrics or m not in b_metrics:
                # a GATED baseline metric absent from the fresh run is a
                # failure, not an info row — otherwise an import breakage
                # that skips a whole benchmark silently disables the gate
                # (tiny runs are guaranteed to contain every gated metric)
                gated_base = b_metrics.get(m, {}).get("gate", False)
                verdicts.append(Verdict(group, bench, m,
                                        "regression" if gated_base
                                        else "missing"))
                continue
            nv, bv = n_metrics[m]["value"], b_metrics[m]["value"]
            v = Verdict(group, bench, m, "info", nv, bv)
            # the BASELINE's flags define the contract under test
            if b_metrics[m].get("gate"):
                hib = b_metrics[m].get("higher_is_better", True)
                if hib and nv < bv * (1.0 - tol):
                    v.status = "regression"
                elif not hib and nv > bv * (1.0 + tol):
                    v.status = "regression"
                elif (hib and nv > bv * (1.0 + tol)) or \
                        (not hib and nv < bv * (1.0 - tol)):
                    v.status = "improved"
                else:
                    v.status = "ok"
            verdicts.append(v)
    return verdicts


def compare_dirs(new_dir: str, base_dir: str,
                 tol: float = 0.2) -> Tuple[bool, List[Verdict]]:
    """Compare every BENCH_<group>.json; returns (passed, verdicts)."""
    verdicts: List[Verdict] = []
    for group in GROUPS:
        verdicts += compare_group(load(new_dir, group),
                                  load(base_dir, group), group, tol)
    passed = not any(v.status == "regression" for v in verdicts)
    return passed, verdicts


def format_report(verdicts: List[Verdict], tol: float) -> str:
    lines = [f"{'status':12s} {'benchmark':24s} {'metric':36s} "
             f"{'new':>12s} {'baseline':>12s} {'ratio':>7s}"]
    order = {"regression": 0, "improved": 1, "ok": 2, "info": 3, "missing": 4}
    for v in sorted(verdicts, key=lambda v: (order[v.status], v.bench,
                                             v.metric)):
        if v.new != v.new or v.base != v.base:       # NaN → absent value
            lines.append(f"{v.status:12s} {v.bench:24s} {v.metric:36s} "
                         f"{'—':>12s} {'—':>12s} {'—':>7s}")
        else:
            lines.append(f"{v.status:12s} {v.bench:24s} {v.metric:36s} "
                         f"{v.new:12.4f} {v.base:12.4f} {v.ratio:7.3f}")
    n_reg = sum(v.status == "regression" for v in verdicts)
    n_gate = sum(v.status in ("regression", "improved", "ok")
                 for v in verdicts)
    lines.append(f"gated: {n_gate}  regressions (>{tol:.0%}): {n_reg}")
    return "\n".join(lines)


def perfdiff_report(new_dir: str, base_dir: str, tol: float = 0.2) -> str:
    """Phase-level localization for a tripped gate: perfdiff every trace
    filename present in BOTH directories (baseline = A, fresh = B).
    Purely diagnostic — returns "" when no pair matches or the traces
    can't be read, never raises."""
    try:
        from ..obs import prof as _prof
        from ..obs.trace import load as _load
        new_traces = {os.path.basename(p) for pat in ("TRACE_*.jsonl",
                                                      "TRACE_*.jsonl.gz")
                      for p in glob.glob(os.path.join(new_dir, pat))}
        base_traces = {os.path.basename(p) for pat in ("TRACE_*.jsonl",
                                                       "TRACE_*.jsonl.gz")
                       for p in glob.glob(os.path.join(base_dir, pat))}
        out = []
        for name in sorted(new_traces & base_traces):
            d = _prof.perfdiff(_load(os.path.join(base_dir, name)),
                               _load(os.path.join(new_dir, name)), tol=tol)
            out.append(f"phase-level perfdiff for {name} "
                       f"(A=baseline, B=fresh):")
            out.append(_prof.render_perfdiff(d))
        return "\n".join(out)
    except Exception as exc:                      # pragma: no cover
        return f"(perfdiff localization unavailable: {exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("new_dir", help="directory with freshly emitted "
                                    "BENCH_*.json (e.g. bench_out/)")
    ap.add_argument("--baseline", default=BASELINE_DIR,
                    help="directory with committed baselines (default: "
                         "the port's, src/repro_torch/bench/baseline)")
    ap.add_argument("--tol", type=float, default=0.2,
                    help="gate tolerance as a fraction (default 0.2 = ±20%%)")
    args = ap.parse_args(argv)
    passed, verdicts = compare_dirs(args.new_dir, args.baseline, args.tol)
    print(format_report(verdicts, args.tol))
    if not passed:
        print("PERF GATE FAILED — gated metric regressed beyond tolerance")
        diag = perfdiff_report(args.new_dir, args.baseline, args.tol)
        if diag:
            print(diag)
        return 1
    print("perf gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
