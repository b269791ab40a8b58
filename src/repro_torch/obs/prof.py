"""Phase-attribution profiler: deterministic per-phase wall-time rollups.

The perf story before this module was binary — a ±20% gate over
point-in-time ``BENCH_*.json`` snapshots could say *that* something got
slower, never *which stage*.  This module rides the existing
:class:`repro_torch.obs.trace.Tracer` to answer the second question:

* **accumulation** (:class:`PhaseAcc`) — every Tracer owns one.  Both
  engines (the heapq oracle and the vectorized fast path) bracket their
  real stages with ``prof.begin(name)`` / ``prof.end()`` pairs:
  contact-plan extension (``plan_extend``), sync scheduling
  (``assign``), per-engine caches (``state_build``), the event loop
  (``event_loop``) and its hot interior — window-fit searches
  (``window_fit``), channel/ARQ commits (``tx_commit``), batched async
  routing (``dispatch`` / ``window_query``, fast path) and per-dispatch
  route choice (``route``, oracle) — plus kernel dispatches
  (``kernel.<name>`` leaves via :mod:`repro_torch.kernels.ops`, host
  dispatch time only).  Nesting is tracked with an explicit stack, so
  each occurrence lands on its full *path* (``event_loop/window_fit``);
  the per-call cost is two ``perf_counter`` reads and a dict update,
  which keeps the whole layer inside the <5% ``sim.trace_overhead``
  budget at mega-1000;
* **emission** — :meth:`PhaseAcc.flush` runs once per round / async run
  (from the ``Engine.run_round`` / ``run_async`` wrappers): one
  ``phase`` record per path (count + summed seconds) and one
  ``phase_total`` record carrying the measured round wall time, plus a
  per-path ``phase:<path>`` histogram of per-round totals (p50/p99 via
  :meth:`repro_torch.obs.metrics.Histogram.percentile`).  Host timings are
  nondeterministic, so neither kind is a trace-diff kind — fast and
  oracle traces still diff clean;
* **rollup** (:func:`collect` / :func:`render_profile`) — per-phase
  count / total / self (total minus direct children) / %wall /
  p50 / p99, with the *unattributed residual* (wall minus top-level
  engine phases) reported explicitly.  ``kernel.*``
  top-level paths are excluded from the attributed sum: on federated
  traces kernel dispatches can run *between* engine rounds, and the
  attribution claim is about round-wall coverage by engine stages;
* **flame** (:func:`folded`) — Brendan-Gregg folded-stacks text
  (``path;leaf self_µs`` per line) that speedscope / inferno /
  flamegraph.pl all read;
* **perfdiff** (:func:`perfdiff` / :func:`render_perfdiff`) — aligns two
  profiles by path, normalizes per round, and names the top regressed
  phases with deltas;
* **bench history** (:func:`ingest_bench` / :func:`render_history`) —
  folds successive ``BENCH_*.json`` emissions into an append-only
  ``runs/bench_history.jsonl`` (content-hashed entries, idempotent like
  the run ledger) and renders per-metric trajectories with
  regression-onset localization (first entry that degrades beyond
  tolerance against the best value seen before it).

The port's copy of the JAX package's ``obs/prof.py``; its command line
is ``python -m repro_torch.obs prof | perfdiff | bench-history``.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import PHASE_BOUNDS, Histogram

DEFAULT_HISTORY = os.path.join("runs", "bench_history.jsonl")

# record kinds emitted by PhaseAcc.flush (host timing — NOT diff kinds)
PHASE_KINDS = ("phase", "phase_total")


class PhaseAcc:
    """Per-tracer phase accumulator (stack-based, reset every flush).

    Hot-path contract: ``begin``/``end`` cost two ``perf_counter`` reads
    plus one dict update — no allocation beyond a short tuple — and the
    engines only call them with an active tracer (the disabled path
    stays one module attribute read per round).  The stack is cleared on
    :meth:`flush`, so an exception that escapes mid-round cannot poison
    the next round's nesting.
    """

    __slots__ = ("_stack", "_acc")

    def __init__(self):
        self._stack: List[tuple] = []     # (path_tuple, t0) frames
        self._acc: Dict[tuple, list] = {}  # path -> [count, total_s]

    def begin(self, name: str) -> None:
        st = self._stack
        path = (st[-1][0] + (name,)) if st else (name,)
        st.append((path, time.perf_counter()))

    def end(self) -> None:
        t1 = time.perf_counter()
        path, t0 = self._stack.pop()
        e = self._acc.get(path)
        if e is None:
            self._acc[path] = [1, t1 - t0]
        else:
            e[0] += 1
            e[1] += t1 - t0

    def add(self, name: str, dur: float) -> None:
        """Record one externally-timed occurrence (kernel dispatches)."""
        st = self._stack
        path = (st[-1][0] + (name,)) if st else (name,)
        e = self._acc.get(path)
        if e is None:
            self._acc[path] = [1, dur]
        else:
            e[0] += 1
            e[1] += dur

    def add_many(self, path: Tuple[str, ...], count: int,
                 total: float) -> None:
        """Fold an externally-accumulated (count, total) into an explicit
        path.  The fast engine's hot interior (window fits, channel
        commits — thousands of occurrences per mega round) accumulates
        inline with two ``perf_counter`` reads and two float adds per
        occurrence, then folds here once per round: ~4x cheaper per
        occurrence than a begin/end pair, which is what keeps the phase
        layer inside the 1.05x ``sim.trace_overhead`` gate."""
        if count:
            e = self._acc.get(path)
            if e is None:
                self._acc[path] = [count, total]
            else:
                e[0] += count
                e[1] += total

    def flush(self, trc, *, engine: str, mode: str, wall: float,
              round: Optional[int] = None, run: Optional[int] = None
              ) -> None:
        """Emit the accumulated phases as trace records and reset.

        One ``phase`` record per path plus one ``phase_total`` with the
        measured wall; per-path per-round totals feed ``phase:<path>``
        histograms for the rollup's p50/p99 columns."""
        acc = self._acc
        key = "round" if round is not None else "run"
        idx = round if round is not None else run
        mtr = trc.metrics
        for path in sorted(acc):
            cnt, tot = acc[path]
            p = "/".join(path)
            trc.raw({"kind": "phase", "engine": engine, "mode": mode,
                     key: idx, "path": p, "count": cnt, "total": tot})
            mtr.histogram("phase:" + p, bounds=PHASE_BOUNDS,
                          lo=0.0).observe(tot)
        trc.raw({"kind": "phase_total", "engine": engine, "mode": mode,
                 key: idx, "wall": wall})
        acc.clear()
        self._stack.clear()


# ---------------------------------------------------------------------------
# rollup
# ---------------------------------------------------------------------------

def collect(records: Sequence[dict]) -> dict:
    """Aggregate a trace's phase records into one profile.

    Returns ``{"phases": {path: {count, total, units}}, "wall": s,
    "units": n, "hists": {path: snapshot}, "engines": [...],
    "modes": [...]}`` — ``units`` counts rounds + async runs."""
    phases: Dict[str, dict] = {}
    wall = 0.0
    units = 0
    engines: set = set()
    modes: set = set()
    hists: Dict[str, dict] = {}
    for r in records:
        kind = r.get("kind")
        if kind == "phase":
            e = phases.setdefault(r["path"],
                                  {"count": 0, "total": 0.0, "units": 0})
            e["count"] += r["count"]
            e["total"] += r["total"]
            e["units"] += 1
        elif kind == "phase_total":
            wall += r["wall"]
            units += 1
            engines.add(r.get("engine"))
            modes.add(r.get("mode"))
        elif kind == "metrics":
            for name, h in r.get("histograms", {}).items():
                if name.startswith("phase:"):
                    hists[name[len("phase:"):]] = h
    return {"phases": phases, "wall": wall, "units": units, "hists": hists,
            "engines": sorted(e for e in engines if e),
            "modes": sorted(m for m in modes if m)}


def _children(phases: Dict[str, dict], path: str) -> List[str]:
    pre = path + "/"
    return [p for p in phases if p.startswith(pre)
            and "/" not in p[len(pre):]]


def self_times(phases: Dict[str, dict]) -> Dict[str, float]:
    """Per-path self time: total minus the sum of direct children."""
    return {p: e["total"] - sum(phases[c]["total"]
                                for c in _children(phases, p))
            for p, e in phases.items()}


def attribution(profile: dict) -> Tuple[float, float]:
    """(attributed_seconds, fraction-of-wall) over top-level engine
    phases.  ``kernel.*`` roots are excluded — on federated traces they
    can run between rounds, and the claim is round-wall coverage."""
    att = sum(e["total"] for p, e in profile["phases"].items()
              if "/" not in p and not p.startswith("kernel."))
    wall = profile["wall"]
    return att, (att / wall if wall > 0 else 0.0)


def _pctl(hist_dict: Optional[dict], q: float) -> Optional[float]:
    if not hist_dict or not hist_dict.get("count"):
        return None
    return Histogram.from_dict(hist_dict).percentile(q)


def render_profile(profile: dict, title: str = "") -> str:
    """Human table: per-phase count/total/self/%wall/p50/p99 plus the
    explicit unattributed residual."""
    phases = profile["phases"]
    wall = profile["wall"]
    selfs = self_times(phases)
    lines = []
    if title:
        lines.append(title)
    lines.append(f"{'phase':40s} {'count':>8s} {'total_s':>10s} "
                 f"{'self_s':>10s} {'%wall':>6s} {'p50_ms':>8s} "
                 f"{'p99_ms':>8s}")
    for path in sorted(phases):    # lexicographic = children after parent
        e = phases[path]
        depth = path.count("/")
        name = "  " * depth + path.split("/")[-1]
        pct = 100.0 * e["total"] / wall if wall > 0 else 0.0
        h = profile["hists"].get(path)
        p50, p99 = _pctl(h, 50), _pctl(h, 99)
        lines.append(
            f"{name:40s} {e['count']:8d} {e['total']:10.4f} "
            f"{selfs[path]:10.4f} {pct:5.1f}% "
            f"{(p50 or 0.0) * 1e3:8.3f} {(p99 or 0.0) * 1e3:8.3f}")
    att, frac = attribution(profile)
    residual = wall - att
    pct = 100.0 * residual / wall if wall > 0 else 0.0
    lines.append(f"{'(unattributed residual)':40s} {'':8s} "
                 f"{residual:10.4f} {'':10s} {pct:5.1f}%")
    units = profile["units"]
    lines.append(
        f"wall {wall:.4f}s over {units} unit(s) "
        f"[engine={'+'.join(profile['engines']) or '?'}, "
        f"mode={'+'.join(profile['modes']) or '?'}]; "
        f"attributed {100.0 * frac:.1f}%")
    return "\n".join(lines)


def folded(profile: dict) -> str:
    """Brendan-Gregg folded stacks (``a;b;c self_µs`` lines) — feed to
    speedscope, inferno, or flamegraph.pl."""
    phases = profile["phases"]
    selfs = self_times(phases)
    out = []
    for path in sorted(phases):
        us = int(round(max(selfs[path], 0.0) * 1e6))
        if us > 0:
            out.append(path.replace("/", ";") + f" {us}")
    att, _ = attribution(profile)
    res_us = int(round(max(profile["wall"] - att, 0.0) * 1e6))
    if res_us > 0:
        out.append(f"(unattributed) {res_us}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# perfdiff
# ---------------------------------------------------------------------------

def perfdiff(records_a: Sequence[dict], records_b: Sequence[dict],
             tol: float = 0.2, top: int = 8) -> dict:
    """Diff two phase profiles (A = reference, B = fresh).

    Totals are normalized per unit (round / async run) so profiles with
    different round counts compare fairly.  Returns ``{"rows": [...],
    "offenders": [...], ...}``.  Offenders are ranked by *self*-time
    growth beyond ``tol`` (worst absolute self delta first): a slowdown
    inside a nested phase inflates every enclosing parent's total too,
    and ranking by totals would name ``event_loop`` when the regression
    lives in ``event_loop/tx_commit``."""
    pa, pb = collect(records_a), collect(records_b)
    sa, sb = self_times(pa["phases"]), self_times(pb["phases"])
    ua = max(pa["units"], 1)
    ub = max(pb["units"], 1)
    rows = []
    for path in sorted(set(pa["phases"]) | set(pb["phases"])):
        ta = pa["phases"].get(path, {}).get("total", 0.0) / ua
        tb = pb["phases"].get(path, {}).get("total", 0.0) / ub
        fa = sa.get(path, 0.0) / ua
        fb = sb.get(path, 0.0) / ub
        ratio = tb / ta if ta > 0 else (float("inf") if tb > 0 else 1.0)
        sratio = fb / fa if fa > 0 else (float("inf") if fb > 0 else 1.0)
        rows.append({"path": path, "a": ta, "b": tb, "delta": tb - ta,
                     "ratio": ratio, "self_a": fa, "self_b": fb,
                     "self_delta": fb - fa, "self_ratio": sratio})
    rows.sort(key=lambda r: -abs(r["delta"]))
    offenders = sorted(
        (r for r in rows
         if r["self_delta"] > 0 and r["self_ratio"] > 1.0 + tol),
        key=lambda r: -r["self_delta"])[:top]
    return {"rows": rows, "offenders": offenders,
            "wall_a": pa["wall"] / ua, "wall_b": pb["wall"] / ub,
            "units_a": pa["units"], "units_b": pb["units"]}


def render_perfdiff(d: dict, top: int = 8) -> str:
    lines = [f"per-unit wall: A {d['wall_a']:.4f}s ({d['units_a']} units) "
             f"vs B {d['wall_b']:.4f}s ({d['units_b']} units)",
             f"{'phase':40s} {'A_s/unit':>10s} {'B_s/unit':>10s} "
             f"{'delta_s':>10s} {'ratio':>7s}"]
    for r in d["rows"][:top]:
        ratio = (f"{r['ratio']:7.2f}" if r["ratio"] != float("inf")
                 else "    new")
        lines.append(f"{r['path']:40s} {r['a']:10.4f} {r['b']:10.4f} "
                     f"{r['delta']:+10.4f} {ratio}")
    if d["offenders"]:
        lines.append("top regressed phases (by self time): " + ", ".join(
            f"{o['path']} (+{o['self_delta'] * 1e3:.2f}ms/unit, "
            + ("new" if o["self_ratio"] == float("inf")
               else f"{o['self_ratio']:.2f}x") + ")"
            for o in d["offenders"]))
    else:
        lines.append("no phase regressed beyond tolerance")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# bench history
# ---------------------------------------------------------------------------

def bench_id(benchmarks: dict) -> str:
    """Deterministic 12-hex content hash over the benchmark metrics —
    the same idiom as the run ledger's ``run_id``, so re-ingesting an
    identical emission appends nothing."""
    blob = json.dumps(benchmarks, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def load_history(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return [e for e in out if e.get("kind") == "bench"]


def ingest_bench(path: str, history_path: str = DEFAULT_HISTORY, *,
                 sha: Optional[str] = None) -> Tuple[dict, bool]:
    """Fold one ``BENCH_<group>.json`` into the append-only history.

    Returns ``(entry, appended)`` — idempotent on the content hash."""
    from .ledger import git_sha          # lazy: keeps prof import-light
    with open(path) as f:
        doc = json.load(f)
    group = os.path.basename(path)
    if group.startswith("BENCH_") and group.endswith(".json"):
        group = group[len("BENCH_"):-len(".json")]
    entry = {"kind": "bench", "group": group,
             "tiny": bool(doc.get("tiny", False)),
             "bench_id": bench_id(doc.get("benchmarks", {})),
             "git_sha": sha if sha is not None else git_sha(),
             "benchmarks": doc.get("benchmarks", {})}
    existing = {(e["group"], e["bench_id"]) for e in
                load_history(history_path)}
    if (entry["group"], entry["bench_id"]) in existing:
        return entry, False
    d = os.path.dirname(history_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(history_path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True, allow_nan=False) + "\n")
    return entry, True


def _onset(values: List[float], hib: bool, tol: float) -> Optional[int]:
    """First index whose value degrades beyond ``tol`` against the best
    value seen before it (direction-aware); None when clean."""
    best = None
    for i, v in enumerate(values):
        if best is not None:
            if hib and v < best * (1.0 - tol):
                return i
            if not hib and v > best * (1.0 + tol):
                return i
        if best is None or (hib and v > best) or (not hib and v < best):
            best = v
    return None


def render_history(entries: Sequence[dict], tol: float = 0.2) -> str:
    """Per-metric trajectories across ingested emissions, localizing the
    regression-onset entry (index + git sha) for any gated metric that
    degraded beyond ``tol``."""
    if not entries:
        return "(empty bench history)"
    series: Dict[Tuple[str, str, str], dict] = {}
    for i, e in enumerate(entries):
        for bench, metrics in e.get("benchmarks", {}).items():
            for m, md in metrics.items():
                s = series.setdefault(
                    (e["group"], bench, m),
                    {"values": [], "idx": [], "shas": [], "meta": md})
                s["values"].append(md["value"])
                s["idx"].append(i)
                s["shas"].append(e.get("git_sha", "?"))
                s["meta"] = md          # latest flags win
    lines = [f"bench history: {len(entries)} emission(s)"]
    n_reg = 0
    for (group, bench, m) in sorted(series):
        s = series[(group, bench, m)]
        md = s["meta"]
        gated = md.get("gate", False)
        traj = " -> ".join(f"{v:.4g}" for v in s["values"][-8:])
        tag = " [gate]" if gated else ""
        line = f"  {bench}.{m}{tag}: {traj}"
        onset = _onset(s["values"], md.get("higher_is_better", True), tol)
        if onset is not None and gated:
            n_reg += 1
            prev_best = (max if md.get("higher_is_better", True)
                         else min)(s["values"][:onset])
            line += (f"\n    REGRESSION ONSET at emission "
                     f"#{s['idx'][onset]} (git {s['shas'][onset]}): "
                     f"{s['values'][onset]:.4g} vs best {prev_best:.4g} "
                     f"(tol {tol:.0%})")
        lines.append(line)
    lines.append(f"gated regressions localized: {n_reg}")
    return "\n".join(lines)
