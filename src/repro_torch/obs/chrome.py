"""Chrome-trace (Perfetto-loadable) exporter for obs trace records.

Counterpart of ``repro.obs.chrome``: for the same records both packages
give the same dict.
Maps the JSONL event schema onto the Chrome Trace Event Format so a
mega-1000 round is visually inspectable in https://ui.perfetto.dev (or
chrome://tracing): open the exported ``.json`` and every delivery shows
as a slice on its ground-station track, rounds as slices on a rounds
track, ARQ losses as instants, and host-side stage/kernel spans on their
own process.

Two clock domains map onto the single trace timeline:

* sim-time events (deliveries, rounds, cohorts) use simulated seconds
  scaled to µs — pids ``1`` (deliveries, one thread per ground station),
  ``2`` (engine rounds), ``4`` (federated rounds);
* host-time spans (kernel dispatches, runner stages) use wall seconds
  since tracer start — pid ``3``;
* phase rollups (:mod:`repro_torch.obs.prof`) are per-round *sums*, not
  timestamped spans, so pid ``5`` renders them as a synthetic-timeline
  icicle: each round/run lays its phases out sequentially from the
  previous round's end (children inside their parents), which preserves
  relative widths — the thing a flame view is for — without pretending
  the rollup knows real start times;
* ``series`` samples (schema v2) map to counter tracks on pid ``6``
  keyed by step (not time); non-finite values are skipped so the JSON
  stays loadable (Perfetto rejects NaN).

They share an origin but not a rate; the pid split keeps them on
separate tracks so the mismatch can't mislead.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List

_US = 1e6    # seconds → microseconds

PID_DELIVERIES = 1
PID_ROUNDS = 2
PID_HOST = 3
PID_FL = 4
PID_PROF = 5
PID_SERIES = 6

_PROCESS_NAMES = {
    PID_DELIVERIES: "sim: deliveries (per ground station)",
    PID_ROUNDS: "sim: engine rounds",
    PID_HOST: "host: stages & kernel dispatches",
    PID_FL: "federated rounds (SpaceRunner)",
    PID_PROF: "prof: phase rollups (synthetic timeline)",
    PID_SERIES: "series (x-axis = step, not time)",
}


def _phase_unit_events(pending: List[dict], wall: float, label: str,
                       offset: float) -> List[dict]:
    """Icicle layout for one flushed unit's phase records: depth-1
    phases sequential from the unit's start, children recursively from
    their parent's start — widths are the measured totals."""
    totals = {r["path"]: r for r in pending}
    ev = [{"ph": "X", "pid": PID_PROF, "tid": 0, "ts": offset * _US,
           "dur": wall * _US, "name": label, "cat": "phase_total",
           "args": {"wall_s": wall}}]

    def lay(paths: List[str], t0: float, depth: int) -> None:
        cursor = t0
        for p in paths:
            r = totals[p]
            ev.append({"ph": "X", "pid": PID_PROF, "tid": 0,
                       "ts": cursor * _US, "dur": r["total"] * _US,
                       "name": p.split("/")[-1], "cat": "phase",
                       "args": {"path": p, "count": r["count"],
                                "total_s": r["total"]}})
            kids = sorted(q for q in totals
                          if q.startswith(p + "/")
                          and "/" not in q[len(p) + 1:])
            if kids:
                lay(kids, cursor, depth + 1)
            cursor += r["total"]

    lay(sorted(p for p in totals if "/" not in p), offset, 0)
    return ev


def chrome_trace(records: List[dict]) -> dict:
    """Convert obs records (``Tracer.records()`` / ``trace.load``) into a
    Chrome Trace Event Format dict (``json.dump`` it for Perfetto)."""
    ev: List[dict] = []
    for pid, name in _PROCESS_NAMES.items():
        ev.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": name}})
    bytes_cum = 0.0
    prof_pending: List[dict] = []
    prof_offset = 0.0
    series_tids: Dict[str, int] = {}
    for r in records:
        kind = r.get("kind")
        if kind == "delivery":
            t0, t1 = r["t_start"], r["t_done"]
            ev.append({
                "ph": "X", "pid": PID_DELIVERIES, "tid": r["station"],
                "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US,
                "name": f"sat {r['sat']}" + ("" if r["delivered"]
                                             else " (LOST)"),
                "cat": "delivery",
                "args": {k: r[k] for k in ("sat", "gateway", "hops",
                                           "nbytes", "nbytes_attempted",
                                           "retries", "delivered")
                         if k in r},
            })
        elif kind == "arq":
            ev.append({
                "ph": "i", "pid": PID_DELIVERIES, "tid": r["station"],
                "ts": r["t_done"] * _US, "s": "t", "cat": "arq",
                "name": (f"arq sat {r['sat']}: {r['retries']} retx"
                         + ("" if r["delivered"] else ", lost")),
            })
        elif kind == "round":
            ev.append({
                "ph": "X", "pid": PID_ROUNDS, "tid": 0,
                "ts": r["t0"] * _US, "dur": r["duration"] * _US,
                "name": f"round {r['round']}", "cat": "round",
                "args": {k: r[k] for k in ("n_scheduled", "n_delivered",
                                           "n_lost", "bytes_air", "engine")
                         if k in r},
            })
            bytes_cum += r.get("bytes_air", 0.0)
            ev.append({"ph": "C", "pid": PID_ROUNDS, "tid": 0,
                       "ts": (r["t0"] + r["duration"]) * _US,
                       "name": "bytes_air (cumulative)",
                       "args": {"bytes": bytes_cum}})
        elif kind == "cohort":
            ev.append({
                "ph": "X", "pid": PID_ROUNDS, "tid": 1 + r["station"],
                "ts": r["t_first"] * _US,
                "dur": max(r["t_last"] - r["t_first"], 0.0) * _US,
                "name": f"cohort gs{r['station']} ({r['n_sats']} sats)",
                "cat": "cohort", "args": {"nbytes": r.get("nbytes")},
            })
        elif kind == "fl_round":
            args = {k: r[k] for k in ("bytes_up", "n_active", "error",
                                      "staleness", "n_lost") if k in r
                    and r[k] is not None}
            ev.append({
                "ph": "X", "pid": PID_FL, "tid": 0,
                "ts": r.get("t0", 0.0) * _US,
                "dur": max(r.get("t", 0.0) - r.get("t0", 0.0), 0.0) * _US,
                "name": f"fl_round {r['round']}", "cat": "fl_round",
                "args": args,
            })
        elif kind == "phase":
            prof_pending.append(r)
        elif kind == "phase_total":
            unit = ("round" if "round" in r else "run",
                    r.get("round", r.get("run")))
            label = (f"{r.get('engine', '?')} {r.get('mode', '?')} "
                     f"{unit[0]} {unit[1]}")
            ev.extend(_phase_unit_events(prof_pending, r["wall"], label,
                                         prof_offset))
            prof_offset += r["wall"]
            prof_pending = []
        elif kind == "series":
            v = r["value"]
            if not math.isfinite(v):
                continue            # Perfetto rejects NaN/inf JSON
            tid = series_tids.setdefault(r["name"], len(series_tids))
            ev.append({"ph": "C", "pid": PID_SERIES, "tid": tid,
                       "ts": r["step"] * _US, "name": r["name"],
                       "args": {"value": v}})
        elif "t_host" in r and "dur_host" in r:       # kernel / span / …
            ev.append({
                "ph": "X", "pid": PID_HOST, "tid": 0,
                "ts": r["t_host"] * _US, "dur": r["dur_host"] * _US,
                "name": r.get("name", kind), "cat": kind,
                "args": {k: v for k, v in r.items()
                         if k not in ("kind", "name", "t_host", "dur_host")},
            })
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(records: List[dict], path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(records), f)
    return path
