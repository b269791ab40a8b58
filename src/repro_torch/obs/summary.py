"""Summarize, diff, and check obs traces.

A copy of the JAX package's ``repro.obs.summary``, with the same output
string for string:

* :func:`summarize`: per-round table (engine rounds or federated
  ``fl_round`` records, whichever the trace carries) plus delivery and
  metrics totals; :func:`summarize_dict` is its machine-readable
  counterpart, and :func:`extract_series` the curves that
  :mod:`repro_torch.obs.report`'s gate reads;
* :func:`diff`: ordered comparison of the deterministic sim-schema
  events of two traces; localizes the first diverging record;
* :func:`check`: trace invariants (bytes conservation, delivery
  ordering, count consistency).

All three operate on record lists (``trace.load(path)`` or
``Tracer.records()``), so tests and examples can run them in memory.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import HOST_FIELDS

# the deterministic engine-emitted kinds: identical for any two engines
# that produced the same Delivery timeline, regardless of fast/oracle
# internals, host timing, or channel implementation details
# (head_elect: per-plane cluster-head elections under in-orbit
# aggregation topologies — a pure function of the contact plan, so fast
# and oracle must agree on it too; fault/head_failover: injected faults
# are counter-based draws on the shared delivery timeline, so the fault
# streams of equivalent engines must also be bit-identical)
DIFF_KINDS = ("round", "delivery", "arq", "cohort", "async_run",
              "head_elect", "fault", "head_failover")

# fields legitimately differing between equivalent traces: host clocks
# and the engine tag ("fast"/"oracle") on round records
DIFF_IGNORE = HOST_FIELDS + ("engine",)


def of_kind(records: Iterable[dict], *kinds: str) -> List[dict]:
    return [r for r in records if r.get("kind") in kinds]


# ---------------------------------------------------------------------------
# summarize
# ---------------------------------------------------------------------------

def _fmt(v, width: int, prec: int = 1) -> str:
    if v is None:
        return " " * (width - 1) + "—"
    if isinstance(v, float):
        return f"{v:{width}.{prec}f}"
    return f"{v:{width}d}"


FL_HEADER = (f"{'round':>5s} {'t_sim':>10s} {'bytes_up':>12s} "
             f"{'active':>6s} {'lost':>5s} {'stale':>6s} "
             f"{'error':>12s}")
ENG_HEADER = (f"{'round':>5s} {'t0':>10s} {'duration':>10s} "
              f"{'sched':>6s} {'deliv':>6s} {'lost':>5s} "
              f"{'bytes_air':>12s} {'engine':>7s}")


def fl_row(r: dict) -> str:
    """One ``fl_round`` record as a table row (shared with ``watch``)."""
    err = r.get("error")
    return (f"{r['round']:5d} {_fmt(r.get('t'), 10)} "
            f"{_fmt(r.get('bytes_up'), 12, 0)} "
            f"{_fmt(r.get('n_active'), 6)} {_fmt(r.get('n_lost', 0), 5)} "
            f"{_fmt(r.get('staleness'), 6, 2)} "
            + (f"{err:12.6f}" if err is not None else f"{'—':>12s}"))


def eng_row(r: dict) -> str:
    """One engine ``round`` record as a table row (shared with ``watch``)."""
    return (f"{r['round']:5d} {r['t0']:10.1f} {r['duration']:10.1f} "
            f"{r['n_scheduled']:6d} {r['n_delivered']:6d} "
            f"{r['n_lost']:5d} {r['bytes_air']:12.0f} "
            f"{r.get('engine', '?'):>7s}")


def render_rounds(records: Sequence[dict]) -> str:
    """Per-round summary table: federated ``fl_round`` records when the
    trace has them (bytes/error/staleness), engine ``round`` records
    otherwise."""
    fl = of_kind(records, "fl_round")
    if fl:
        return "\n".join([FL_HEADER] + [fl_row(r) for r in fl])
    rounds = of_kind(records, "round")
    if not rounds:
        return "(no rounds recorded)"
    return "\n".join([ENG_HEADER] + [eng_row(r) for r in rounds])


# ---------------------------------------------------------------------------
# series extraction (schema v2) + machine-readable summary
# ---------------------------------------------------------------------------

def extract_series(records: Sequence[dict]) -> Dict[str, dict]:
    """Group ``series`` records into ``{name: {"steps": [...],
    "values": [...]}}`` curves, step-ordered.

    Schema-v1 traces predate the ``series`` kind; for those the
    federated curves are synthesized from the ``fl_round`` records
    (``e_K`` from non-null errors, ``bytes_up``, ``staleness``), so the
    ledger and the convergence gate read old and new traces alike.
    """
    out: Dict[str, dict] = {}
    for r in records:
        if r.get("kind") != "series":
            continue
        s = out.setdefault(r["name"], {"steps": [], "values": []})
        s["steps"].append(r["step"])
        s["values"].append(r["value"])
    if not out:      # v1 fallback: derive the federated curves
        for r in of_kind(records, "fl_round"):
            for name, val in (("e_K", r.get("error")),
                              ("bytes_up", r.get("bytes_up")),
                              ("staleness", r.get("staleness"))):
                if val is None:
                    continue
                s = out.setdefault(name, {"steps": [], "values": []})
                s["steps"].append(r["round"])
                s["values"].append(val)
    for s in out.values():
        order = sorted(range(len(s["steps"])), key=s["steps"].__getitem__)
        s["steps"] = [s["steps"][i] for i in order]
        s["values"] = [s["values"][i] for i in order]
    return out


def summarize_dict(records: Sequence[dict]) -> dict:
    """Machine-readable trace summary.

    The single structured view of a trace: header meta, per-round
    records, delivery/async totals, extracted series curves, and the
    metrics snapshot.
    """
    header = records[0] if records and records[0].get("kind") == "header" \
        else {}
    meta = {k: v for k, v in header.items()
            if k not in ("kind", "schema", "n_events", "streamed")}
    fl = of_kind(records, "fl_round")
    eng = of_kind(records, "round")
    rounds = fl or eng
    deliveries = of_kind(records, "delivery")
    out = {
        "schema": header.get("schema"),
        "meta": meta,
        "round_kind": "fl_round" if fl else ("round" if eng else None),
        "n_rounds": len(rounds),
        "rounds": [dict(r) for r in rounds],
        "series": extract_series(records),
        "async_runs": [dict(r) for r in of_kind(records, "async_run")],
        "counters": {}, "histograms": {},
    }
    if deliveries:
        lat = [d["t_done"] - d["t_start"] for d in deliveries]
        out["deliveries"] = {
            "n": len(deliveries),
            "lost": sum(not d["delivered"] for d in deliveries),
            "retx_rounds": sum(d["retries"] for d in deliveries),
            "bytes_air": sum(d["nbytes_attempted"] for d in deliveries),
            "latency_min": min(lat), "latency_max": max(lat),
            "latency_mean": sum(lat) / len(lat),
        }
    else:
        out["deliveries"] = None
    for r in records:
        if r.get("kind") == "metrics":
            out["counters"] = r.get("counters", {})
            out["histograms"] = r.get("histograms", {})
    # final-state convenience block: what the run ledger keys on
    final: dict = {"rounds": len(rounds)}
    if fl:
        last = fl[-1]
        errs = [r["error"] for r in fl if r.get("error") is not None]
        final.update(
            e_K=errs[-1] if errs else None,
            bytes_up=last.get("bytes_up"),
            t=last.get("t"),
            n_lost=sum(r.get("n_lost", 0) or 0 for r in fl),
            n_active=sum(r.get("n_active", 0) or 0 for r in fl),
            mode=last.get("mode"))
    elif eng:
        final.update(
            bytes_air=sum(r["bytes_air"] for r in eng),
            n_delivered=sum(r["n_delivered"] for r in eng),
            n_lost=sum(r["n_lost"] for r in eng))
    out["final"] = final
    return out


def summarize(records: Sequence[dict]) -> str:
    """Full human-readable trace summary."""
    out = [render_rounds(records)]
    deliveries = of_kind(records, "delivery")
    if deliveries:
        lost = sum(not d["delivered"] for d in deliveries)
        retx = sum(d["retries"] for d in deliveries)
        air = sum(d["nbytes_attempted"] for d in deliveries)
        lat = [d["t_done"] - d["t_start"] for d in deliveries]
        out.append(
            f"deliveries: {len(deliveries)} ({lost} lost, {retx} retx "
            f"rounds)  air bytes: {air:.0f}  "
            f"latency s: min {min(lat):.1f} / mean "
            f"{sum(lat) / len(lat):.1f} / max {max(lat):.1f}")
    runs = of_kind(records, "async_run")
    for r in runs:
        out.append(f"async run: {r['n_ok']}/{r['n_deliveries']} delivered "
                   f"ok, air bytes {r['bytes_air']:.0f}, "
                   f"t_end {r['t_end']:.1f}s")
    series = {r["name"] for r in records if r.get("kind") == "series"}
    if series:
        named = extract_series(records)
        out.append("series: " + "  ".join(
            f"{n}[{len(named[n]['steps'])}]"
            f"→{named[n]['values'][-1]:.6g}" for n in sorted(series)))
    kernels = of_kind(records, "kernel")
    if kernels:
        per: dict = {}
        for k in kernels:
            n, s = per.get(k["name"], (0, 0.0))
            per[k["name"]] = (n + 1, s + k["dur_host"])
        out.append("kernel dispatches: " + "  ".join(
            f"{name}×{n} ({s * 1e3:.1f}ms)"
            for name, (n, s) in sorted(per.items())))
    for r in records:
        if r.get("kind") == "metrics":
            cs = r.get("counters", {})
            if cs:
                out.append("counters: " + "  ".join(
                    f"{k}={v['total']:.0f}" for k, v in sorted(cs.items())))
            hs = r.get("histograms", {})
            if hs:
                out.append("histograms: " + "  ".join(
                    f"{k}(n={v['count']}, mean={v['mean']:.2f})"
                    for k, v in sorted(hs.items())))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------

def _strip(r: dict, ignore: Tuple[str, ...]) -> dict:
    return {k: v for k, v in r.items() if k not in ignore}


def diff(a: Sequence[dict], b: Sequence[dict],
         kinds: Optional[Sequence[str]] = None,
         ignore: Tuple[str, ...] = DIFF_IGNORE) -> Tuple[bool, str]:
    """Ordered comparison of the selected event kinds of two traces.

    Returns ``(equal, report)``; on divergence the report names the first
    differing record index (within the filtered stream), its kind, and
    the field-level delta — the trace-level replacement for hand-diffing
    Delivery lists when the fast engine and the heapq oracle disagree.
    """
    kinds = tuple(kinds) if kinds is not None else DIFF_KINDS
    ra = of_kind(a, *kinds)
    rb = of_kind(b, *kinds)
    for i, (x, y) in enumerate(zip(ra, rb)):
        sx, sy = _strip(x, ignore), _strip(y, ignore)
        if sx == sy:
            continue
        fields = sorted(set(sx) | set(sy))
        delta = [f"    {f}: {sx.get(f, '<absent>')!r} != "
                 f"{sy.get(f, '<absent>')!r}"
                 for f in fields if sx.get(f) != sy.get(f)]
        return False, (
            f"DIVERGED at record {i} (kind={x.get('kind')}"
            + (f", round={x.get('round')}" if x.get("round") is not None
               else "") + "):\n" + "\n".join(delta))
    if len(ra) != len(rb):
        longer = "A" if len(ra) > len(rb) else "B"
        extra = (ra if len(ra) > len(rb) else rb)[min(len(ra), len(rb))]
        return False, (
            f"DIVERGED: record counts differ ({len(ra)} vs {len(rb)}); "
            f"first extra record in {longer} is kind={extra.get('kind')!r}")
    return True, f"identical: {len(ra)} records across kinds {list(kinds)}"


# ---------------------------------------------------------------------------
# check
# ---------------------------------------------------------------------------

def check(records: Sequence[dict]) -> List[str]:
    """Trace invariants; returns violation messages (empty = clean).

    1. **bytes conservation** — each engine ``round`` record's
       ``bytes_air`` equals the sum of its delivery records'
       ``nbytes_attempted`` (likewise ``async_run``);
    2. delivery/round count consistency (``n_delivered``/``n_lost``);
    3. deliveries are time-ordered and fit inside their round;
    4. a failed delivery carries zero payload bytes.
    """
    bad: List[str] = []
    by_round: dict = {}
    async_dlv: List[dict] = []
    for d in of_kind(records, "delivery"):
        if d.get("round") is None:
            async_dlv.append(d)
        else:
            by_round.setdefault(d["round"], []).append(d)

    def close(a: float, b: float) -> bool:
        return a == b or math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-6)

    for r in of_kind(records, "round"):
        k = r["round"]
        dlv = by_round.get(k, [])
        air = sum(d["nbytes_attempted"] for d in dlv)
        if not close(air, r["bytes_air"]):
            bad.append(f"round {k}: bytes conservation violated — "
                       f"sum(delivery nbytes_attempted)={air!r} != "
                       f"round bytes_air={r['bytes_air']!r}")
        n_ok = sum(d["delivered"] for d in dlv)
        n_lost = sum(not d["delivered"] for d in dlv)
        if n_ok != r["n_delivered"] or n_lost != r["n_lost"]:
            bad.append(f"round {k}: delivery counts inconsistent — "
                       f"{n_ok} ok/{n_lost} lost in records vs "
                       f"n_delivered={r['n_delivered']}/"
                       f"n_lost={r['n_lost']}")
        t_end = r["t0"] + r["duration"]
        prev = -math.inf
        for d in dlv:
            if d["t_done"] < prev:
                bad.append(f"round {k}: deliveries out of time order "
                           f"(sat {d['sat']} at {d['t_done']})")
            prev = d["t_done"]
            if d["t_done"] > t_end + 1e-6:
                bad.append(f"round {k}: delivery of sat {d['sat']} at "
                           f"{d['t_done']} past round end {t_end}")
            if d["t_done"] < d["t_start"]:
                bad.append(f"round {k}: sat {d['sat']} delivered before "
                           f"it started training")
    for r in of_kind(records, "async_run"):
        air = sum(d["nbytes_attempted"] for d in async_dlv)
        if not close(air, r["bytes_air"]):
            bad.append(f"async run: bytes conservation violated — "
                       f"{air!r} != {r['bytes_air']!r}")
        n_ok = sum(d["delivered"] for d in async_dlv)
        if n_ok != r["n_ok"]:
            bad.append(f"async run: {n_ok} delivered in records vs "
                       f"n_ok={r['n_ok']}")
    for d in of_kind(records, "delivery"):
        if not d["delivered"] and d["nbytes"] != 0.0:
            bad.append(f"delivery sat {d['sat']} failed but carries "
                       f"nbytes={d['nbytes']}")
    prev_up = -math.inf
    for r in of_kind(records, "fl_round"):
        if r["bytes_up"] < prev_up:
            bad.append(f"fl_round {r['round']}: cumulative bytes_up "
                       f"decreased ({r['bytes_up']} < {prev_up})")
        prev_up = r["bytes_up"]
    return bad
