"""Cross-run reporting, live trace watch, and the convergence gate.

Counterpart of ``repro.obs.report``; rendered text is byte for byte the
reference's for the same ledger entries.  Three consumers of the run
ledger (:mod:`repro_torch.obs.ledger`):

* :func:`render_report` / :func:`render_frontier` — cross-run comparison
  tables and the paper's central curve, the **bytes-to-ground vs e_K
  frontier** (``python -m repro_torch.obs report``).  The tables of
  ``repro_torch.bench.table_lossy_ef``, ``table_plane_agg`` and
  ``table_fault_tolerance`` render their rows only through
  :func:`lossy_ef_rows`, :func:`plane_agg_rows` and
  :func:`fault_tolerance_rows`, from ledger entries;
* :func:`watch` — tail a live trace (reader-side only: the traced
  process is untouched) with the per-round table, round rate, and ETA;
* :func:`convgate` — the committed reference e_K curves of the four
  canonical scenarios (``CONV_reference.json``) held round by round
  against a fresh run or existing traces; degradation beyond tolerance
  exits 1 naming the scenario, round, and metric.

The reference curves were drawn with ``jax.random`` from seed
``CANONICAL_SEED``, which the port cannot reproduce.  ``run_canonical``
therefore takes the problem as an optional ``problem=(data, x_star)``;
without it the port's own :func:`repro_torch.data.logistic.generate`
draws one from ``CANONICAL_SEED``.  ``bytes_up`` does not depend on the
draw; e_K does.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import ledger as _ledger
from .summary import (ENG_HEADER, FL_HEADER, eng_row, extract_series,
                      fl_row)
from .trace import load

REFERENCE_PATH = "CONV_reference.json"
# where the port's re-run curves go: the committed file above holds the JAX
# package's curves, which the gate reads and the port never overwrites
UPDATE_PATH = os.path.join("results", "torch", "CONV_reference.json")
REF_SCHEMA = 1
DEFAULT_TOL = 0.25        # e_K may degrade by at most 25% at any round
DEFAULT_TOL_BYTES = 0.01  # byte accounting is deterministic: ±1% only


# ---------------------------------------------------------------------------
# cross-run report + frontier
# ---------------------------------------------------------------------------

def _label(e: dict) -> str:
    """Human row label: the meta ``arm`` when present (sweep tables),
    else algorithm@scenario."""
    arm = e.get("meta", {}).get("arm")
    if arm:
        return str(arm)
    alg = e.get("algorithm") or "?"
    sc = e.get("scenario") or "?"
    return f"{alg}@{sc}"


def render_report(entries: Sequence[dict]) -> str:
    """Cross-run comparison table over ledger entries."""
    if not entries:
        return "(empty ledger)"
    lines = [f"{'run_id':>12s} {'sha':>9s} {'scenario':>18s} "
             f"{'label':>20s} {'mode':>5s} {'rounds':>6s} "
             f"{'bytes_up':>12s} {'e_K':>12s} {'lost':>6s}"]
    for e in entries:
        f = e.get("final", {})
        ek = f.get("e_K")
        bu = f.get("bytes_up")
        lines.append(
            f"{e['run_id']:>12s} {str(e.get('git_sha'))[:9]:>9s} "
            f"{str(e.get('scenario'))[:18]:>18s} "
            f"{_label(e)[:20]:>20s} {str(e.get('mode'))[:5]:>5s} "
            f"{f.get('rounds', 0):6d} "
            + (f"{bu:12.0f} " if bu is not None else f"{'—':>12s} ")
            + (f"{ek:12.6f} " if ek is not None else f"{'—':>12s} ")
            + f"{f.get('n_lost', 0) or 0:6d}")
    return "\n".join(lines)


def frontier_points(entries: Sequence[dict]) -> List[dict]:
    """Accuracy-vs-communication points: entries with both a final e_K
    and a bytes_up ledger value, bytes-ascending, Pareto members marked.

    A point is on the frontier when no cheaper-or-equal-bytes run
    achieves a strictly lower e_K — the curve the paper's central claim
    lives on (and the one the ROADMAP's in-orbit-aggregation comparison
    will extend)."""
    pts = [{"run_id": e["run_id"], "label": _label(e),
            "scenario": e.get("scenario"),
            "bytes_up": e["final"]["bytes_up"], "e_K": e["final"]["e_K"]}
           for e in entries
           if e.get("final", {}).get("e_K") is not None
           and e.get("final", {}).get("bytes_up") is not None]
    pts.sort(key=lambda p: (p["bytes_up"], p["e_K"]))
    best = math.inf
    for p in pts:
        p["pareto"] = p["e_K"] < best
        best = min(best, p["e_K"])
    return pts


def render_frontier(entries: Sequence[dict]) -> str:
    """The bytes-to-ground vs e_K frontier as a table (``*`` = Pareto)."""
    pts = frontier_points(entries)
    if not pts:
        return "(no runs with both e_K and bytes_up in the ledger)"
    lines = [f"{'':2s}{'bytes_up_kB':>12s} {'e_K':>12s}  label"]
    for p in pts:
        mark = "* " if p["pareto"] else "  "
        lines.append(f"{mark}{p['bytes_up'] / 1e3:12.1f} "
                     f"{p['e_K']:12.6f}  {p['label']}")
    return "\n".join(lines)


def lossy_ef_rows(entries: Sequence[dict]) -> List[dict]:
    """The ``bench/table_lossy_ef.py`` row dicts, rebuilt purely
    from ledger entries (meta: ``loss_rate``/``arm``; final: e_K /
    n_lost / n_active / bytes_up) — the no-recomputation reporting
    path."""
    rows = []
    for e in entries:
        meta, f = e.get("meta", {}), e.get("final", {})
        if "loss_rate" not in meta or "arm" not in meta:
            continue
        rows.append(dict(loss_rate=meta["loss_rate"], arm=meta["arm"],
                         error=f.get("e_K"), lost=f.get("n_lost", 0),
                         received=f.get("n_active", 0),
                         bytes_up=f.get("bytes_up")))
    return rows


def plane_agg_rows(entries: Sequence[dict]) -> List[dict]:
    """The ``bench/table_plane_agg.py`` row dicts, rebuilt purely
    from ledger entries (promoted ``topology`` + meta ``arm``; final:
    e_K / bytes_up / n_active; series: ``bytes_isl_cum``) — same
    no-recomputation contract as :func:`lossy_ef_rows`.

    ``bytes_gs`` is the final cumulative GS air-byte count,
    ``bytes_isl`` the final cumulative ISL wire bytes (0 for direct
    arms), and ``updates`` the total updates the coordinator
    incorporated across the run — the denominator of the per-update
    incast metric the table reports."""
    rows = []
    for e in entries:
        meta, f = e.get("meta", {}), e.get("final", {})
        if "arm" not in meta or e.get("topology") is None:
            continue
        isl = e.get("series", {}).get("bytes_isl_cum",
                                      {"values": []})["values"]
        rows.append(dict(arm=meta["arm"], topology=e.get("topology"),
                         scenario=e.get("scenario"),
                         rounds=f.get("rounds"), error=f.get("e_K"),
                         bytes_gs=f.get("bytes_up"),
                         bytes_isl=isl[-1] if isl else 0.0,
                         updates=f.get("n_active", 0) or 0,
                         lost=f.get("n_lost", 0) or 0))
    return rows


def fault_tolerance_rows(entries: Sequence[dict]) -> List[dict]:
    """The ``bench/table_fault_tolerance.py`` row dicts, rebuilt
    purely from ledger entries (meta: ``crash_rate``/``arm``/``quorum``;
    promoted ``faults``; final: e_K / bytes_up / n_lost; series:
    ``survivors``/``quorum_frac``) — same no-recomputation contract as
    :func:`lossy_ef_rows`."""
    rows = []
    for e in entries:
        meta, f = e.get("meta", {}), e.get("final", {})
        if "crash_rate" not in meta or "arm" not in meta:
            continue
        qf = e.get("series", {}).get("quorum_frac", {"values": []})["values"]
        rows.append(dict(crash_rate=meta["crash_rate"], arm=meta["arm"],
                         quorum=meta.get("quorum", 0.0),
                         faults=e.get("faults"),
                         error=f.get("e_K"), bytes_up=f.get("bytes_up"),
                         lost=f.get("n_lost", 0),
                         t_sim=f.get("t"),
                         quorum_frac=(sum(qf) / len(qf)) if qf else None))
    return rows


# ---------------------------------------------------------------------------
# live watch (reader-side tail of a growing trace)
# ---------------------------------------------------------------------------

class TraceTail:
    """Incremental JSONL reader over a growing trace file.

    Plain files are tailed by byte offset (only complete lines are
    consumed; a partially-written last line waits for the next poll).
    ``.gz`` traces are re-read whole each poll — gzip streams aren't
    seekable mid-write — which stays correct, just not O(new records).
    """

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._partial = ""
        self._gz_seen = 0

    def poll(self) -> List[dict]:
        """All complete records that appeared since the last poll."""
        if self.path.endswith(".gz"):
            try:
                records = load(self.path)
            except (OSError, EOFError, json.JSONDecodeError):
                return []          # mid-write: try again next poll
            new = records[self._gz_seen:]
            self._gz_seen = len(records)
            return new
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            f.seek(self._pos)
            chunk = f.read()
            self._pos = f.tell()
        if not chunk:
            return []
        text = self._partial + chunk
        lines = text.split("\n")
        self._partial = lines.pop()
        out = []
        for ln in lines:
            ln = ln.strip()
            if ln:
                out.append(json.loads(ln))
        return out


def _eta_str(seconds: float) -> str:
    seconds = int(seconds)
    return f"{seconds // 3600:d}:{seconds % 3600 // 60:02d}:{seconds % 60:02d}"


def watch(path: str, total: Optional[int] = None, interval: float = 0.5,
          follow: bool = True, max_wait: Optional[float] = None,
          out=None) -> int:
    """Tail a live trace: per-round table rows as they land, plus round
    rate and ETA (when ``total`` is known).

    Purely reader-side — the traced process never sees the watcher.
    Returns once the trace closes (its metrics snapshot appears), after
    one pass with ``follow=False``, or after ``max_wait`` seconds
    without new records."""
    out = sys.stdout if out is None else out
    tail = TraceTail(path)
    t_start = time.perf_counter()
    t_last_new = t_start
    n_rounds = 0
    printed_header = False
    while True:
        new = tail.poll()
        now = time.perf_counter()
        if new:
            t_last_new = now
        for r in new:
            kind = r.get("kind")
            if kind == "header":
                meta = {k: v for k, v in r.items()
                        if k not in ("kind", "schema", "n_events",
                                     "streamed")}
                out.write(f"watching {path}  schema={r.get('schema')}"
                          + (f"  {meta}" if meta else "") + "\n")
            elif kind in ("fl_round", "round"):
                if not printed_header:
                    out.write((FL_HEADER if kind == "fl_round"
                               else ENG_HEADER) + "\n")
                    printed_header = True
                n_rounds += 1
                row = fl_row(r) if kind == "fl_round" else eng_row(r)
                elapsed = now - t_start
                if elapsed > 0 and n_rounds > 1:
                    rate = n_rounds / elapsed
                    row += f"  | {rate * 60.0:6.1f} r/min"
                    if total:
                        left = max(total - n_rounds, 0)
                        row += f"  ETA {_eta_str(left / rate)}"
                out.write(row + "\n")
            elif kind == "metrics":
                if n_rounds == 0:
                    out.write("no rounds recorded\n")
                out.write(f"trace closed: {n_rounds} rounds in "
                          f"{now - t_start:.1f}s\n")
                return 0
        if not follow:
            if n_rounds == 0:
                out.write("no rounds recorded\n")
            return 0
        if max_wait is not None and now - t_last_new > max_wait:
            if n_rounds == 0:
                out.write("no rounds recorded\n")
            out.write(f"no new records for {max_wait:.0f}s; stopping "
                      f"({n_rounds} rounds seen)\n")
            return 0
        time.sleep(interval)


# ---------------------------------------------------------------------------
# convergence gate
# ---------------------------------------------------------------------------

# the canonical convergence scenarios (name → runner config), copied from
# the JAX package.  Deterministic: fixed seeds, fixed problem sizes,
# deterministic engine timelines.  The FedLT hyperparameters sit where
# error feedback visibly drives convergence under the 10-level quantizer.
CANONICAL: Dict[str, dict] = {
    "sync-lossless": dict(
        scenario="walker-kiruna", mode="sync", rounds=30, loss=None,
        gamma=0.02, rho=2.0),
    "sync-lossy-robust-ef": dict(
        scenario="walker-kiruna", mode="sync", rounds=60, loss=0.3,
        gamma=0.02, rho=2.0),
    "async-mega-1000": dict(
        scenario="mega-1000", mode="async", rounds=8, loss=None,
        n_agents=1000, dim=8, m=16, buffer_size=64,
        gamma=0.02, rho=2.0),
    # scale + erasures + radiation-upset crashes + station blackouts,
    # rounds closed by a quorum deadline
    "sync-mega-chaos": dict(
        scenario="mega-1000-chaos", mode="sync", rounds=8, loss=None,
        n_agents=1000, dim=8, m=16, deadline=45.0, quorum=0.7,
        gamma=0.02, rho=2.0),
}
CANONICAL_SEED = 7


def run_canonical(name: str, *, ef: bool = True, loss_robust: bool = True,
                  rounds: Optional[int] = None, problem=None,
                  device=None) -> List[dict]:
    """Run one canonical convergence scenario under a fresh in-memory
    trace; returns the trace records.

    ``problem=(data, x_star)`` supplies the logistic problem (a data dict
    of arrays or tensors and the optimum); without it the port draws one
    from ``CANONICAL_SEED``.  ``ef=False`` / ``loss_robust=False``
    reproduce the silent failure modes the gate exists to catch.  Runs on
    the card unless ``device="cpu"``."""
    import torch

    from ..api import Experiment
    from ..core.compression import UniformQuantizer
    from ..core.error_feedback import EFChannel
    from ..core.fedlt import FedLT, optimality_error
    from ..data.logistic import generate, make_local_loss, solve_global
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = CANONICAL[name]
    n_agents = cfg.get("n_agents", 100)
    dim, m = cfg.get("dim", 32), cfg.get("m", 40)
    rounds = rounds if rounds is not None else cfg["rounds"]
    if problem is None:
        data, _ = generate(CANONICAL_SEED, n_agents=n_agents, m=m, dim=dim,
                           device=dev)
        x_star = solve_global(data, eps=50.0)
    else:
        data, x_star = problem
        x_star = torch.as_tensor(x_star).to(dev)
    loss_fn = make_local_loss(eps=50.0, n_agents=n_agents)
    quant = UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True)
    alg = FedLT(loss=loss_fn, n_epochs=10, gamma=cfg["gamma"],
                rho=cfg["rho"],
                uplink=EFChannel(quant, enabled=ef),
                downlink=EFChannel(quant, enabled=ef))
    channel = None
    if cfg["loss"] is not None:
        from ..channel import ChannelModel, SelectiveRepeatARQ
        channel = ChannelModel(
            loss=cfg["loss"],
            arq=SelectiveRepeatARQ(seg_bytes=4096, max_rounds=1))
    runner_kw: dict = dict(compressor=quant, channel=channel,
                           loss_robust=loss_robust)
    if cfg.get("deadline") is not None:
        runner_kw.update(deadline=cfg["deadline"],
                         quorum=cfg.get("quorum", 0.0))
    if cfg["mode"] == "async":
        runner_kw.update(mode="async", buffer_size=cfg["buffer_size"],
                         staleness_alpha=0.5)
    exp = Experiment(cfg["scenario"], alg, seed=CANONICAL_SEED,
                     meta=dict(canonical=name), device=dev, **runner_kw)
    st = exp.init(torch.zeros(dim), n_agents)
    err = lambda s: float(optimality_error(s.x, x_star))  # noqa: E731
    return exp.run(st, data, rounds, 100 + CANONICAL_SEED,
                   error_fn=err, log_every=1, trace=True).records


def gate_records(name: str, records: Sequence[dict], reference: dict,
                 tol: Optional[float] = None,
                 tol_bytes: Optional[float] = None) -> List[str]:
    """Compare one run's curves to the committed reference; returns
    failure messages (empty = gate passes), each localized to the
    scenario, round, and metric that regressed."""
    ref = reference["scenarios"].get(name)
    if ref is None:
        return [f"{name}: no reference curve in the reference file "
                f"(known: {sorted(reference['scenarios'])})"]
    tol = reference.get("tol", DEFAULT_TOL) if tol is None else tol
    tol_bytes = (reference.get("tol_bytes", DEFAULT_TOL_BYTES)
                 if tol_bytes is None else tol_bytes)
    series = extract_series(records)
    fresh = series.get("e_K", {"steps": [], "values": []})
    fresh_at = dict(zip(fresh["steps"], fresh["values"]))
    bad: List[str] = []
    for step, rv in zip(ref["e_K"]["steps"], ref["e_K"]["values"]):
        fv = fresh_at.get(step)
        if fv is None:
            bad.append(f"{name}: e_K sample missing at round {step} "
                       f"(reference has one)")
        elif fv > rv * (1.0 + tol):
            bad.append(f"{name}: e_K degraded at round {step}: "
                       f"{fv:.6g} > reference {rv:.6g} × (1+{tol:g})")
    bu = series.get("bytes_up", {"values": []})["values"]
    fresh_bytes = bu[-1] if bu else None
    ref_bytes = ref.get("bytes_up")
    if ref_bytes is not None:
        if fresh_bytes is None:
            bad.append(f"{name}: bytes_up series missing")
        elif abs(fresh_bytes - ref_bytes) > ref_bytes * tol_bytes:
            bad.append(f"{name}: bytes_up drifted: {fresh_bytes:.0f} vs "
                       f"reference {ref_bytes:.0f} (±{tol_bytes:.0%})")
    return bad


def reference_entry(records: Sequence[dict], rounds: int) -> dict:
    series = extract_series(records)
    bu = series.get("bytes_up", {"values": []})["values"]
    return {"rounds": rounds, "seed": CANONICAL_SEED,
            "e_K": series.get("e_K", {"steps": [], "values": []}),
            "bytes_up": bu[-1] if bu else None}


def update_reference(path: str = UPDATE_PATH,
                     names: Optional[Sequence[str]] = None,
                     tol: float = DEFAULT_TOL,
                     tol_bytes: float = DEFAULT_TOL_BYTES,
                     device=None) -> dict:
    """Re-run the canonical scenarios (on the card unless ``device``) and
    (re)write the reference file ``path``: the port's own, not the
    committed ``REFERENCE_PATH``, unless that path is named."""
    names = list(CANONICAL) if names is None else list(names)
    scenarios = {}
    for name in names:
        records = run_canonical(name, device=device)
        scenarios[name] = reference_entry(records, CANONICAL[name]["rounds"])
    doc = {"schema": REF_SCHEMA, "tol": tol, "tol_bytes": tol_bytes,
           "seed": CANONICAL_SEED, "scenarios": scenarios}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def load_reference(path: str = REFERENCE_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def convgate(reference_path: str = REFERENCE_PATH,
             traces: Optional[Sequence[str]] = None,
             scenario: Optional[str] = None,
             ledger_path: Optional[str] = None,
             tol: Optional[float] = None,
             tol_bytes: Optional[float] = None,
             out=None, device=None) -> int:
    """The convergence gate.  Without ``traces``, runs every canonical
    scenario fresh (on the card unless ``device``) and gates each against
    the reference (optionally ingesting the fresh runs into
    ``ledger_path``); with trace paths, gates those existing traces
    (scenario taken from each trace's ``canonical`` header meta unless
    ``scenario`` is given).  Returns the exit code (1 on any failure, 2
    when a trace names no scenario)."""
    out = sys.stdout if out is None else out
    reference = load_reference(reference_path)
    runs: List[Tuple[str, Sequence[dict]]] = []
    if traces:
        for path in traces:
            records = load(path)
            header = records[0] if records else {}
            name = scenario or header.get("canonical")
            if name is None:
                out.write(f"{path}: no canonical scenario in the trace "
                          f"header; pass --scenario\n")
                return 2
            runs.append((name, records))
    else:
        for name in CANONICAL:
            out.write(f"running canonical scenario {name} "
                      f"({CANONICAL[name]['rounds']} rounds)...\n")
            records = run_canonical(name, device=device)
            runs.append((name, records))
            if ledger_path:
                entry, added = _ledger.ingest(records, ledger_path)
                out.write(f"  ingested as {entry['run_id']}"
                          + ("" if added else " (already present)") + "\n")
    rc = 0
    for name, records in runs:
        bad = gate_records(name, records, reference,
                           tol=tol, tol_bytes=tol_bytes)
        if bad:
            rc = 1
            out.write(f"CONVGATE FAIL {name}: {len(bad)} violation(s)\n")
            for msg in bad:
                out.write(f"  {msg}\n")
        else:
            ref = reference["scenarios"][name]
            n = len(ref["e_K"]["steps"])
            out.write(f"CONVGATE OK {name}: {n} e_K samples within "
                      f"tolerance\n")
    return rc
