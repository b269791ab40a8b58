"""Host cost of the simulator's trace emission, and the tracing gate's ratio.

    PYTHONPATH=src python src/repro_torch/bench/trace_emission.py [--calls 20]

It runs the trajectory that ``bench.sim_scale.bench_trace_overhead`` times
on mega-1000 (two sync rounds, then an async run of 100 deliveries, on a
warmed engine), captures what the engine hands its trace emission
(``sim.engine._emit_round_trace`` and ``_emit_async_trace``), and times
the emission alone on that input into fresh in-memory tracers: the least
of ``repeats`` runs of ``iters`` trajectories, in ms per trajectory.  It
prints one JSON line with that time, a sha256 digest of the records and
the metrics snapshot the emission wrote (the stream, so two checkouts can
be held to the same one), the times of ``trajectories`` single untraced
trajectories (their spread, with the same work each time, is the host's
noise that the gate's ratio sees), and then the overhead ratios of
``calls`` calls
of ``bench_trace_overhead()``, the harness's gate (least of 9 interleaved
pairs, one re-measure, < 1.05): a call that breaches the gate is counted,
its ratio kept, and the script exits 1.

The script imports only ``repro_torch``, so it times another checkout's
emission when run by its path with ``PYTHONPATH`` at that checkout's
``src`` and ``--calls 0``; equal digests mean the same stream.  The
emission runs on the host, so the script needs no card; it names the
host's processor and, where there is one, the card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys
import time


def host() -> dict:
    """The processor (from /proc/cpuinfo where there is one) and the card's
    name and power limit as nvidia-smi reports them, or None."""
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next(line.split(":", 1)[1].strip() for line in f
                       if line.startswith("model name"))
    except (OSError, StopIteration):
        pass
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = None
    return {"cpu": cpu, "cores": os.cpu_count(), "card": card}


def capture(n_sats: int = 1000, trajectories: int = 0):
    """The emission calls of one warmed ``bench_trace_overhead`` trajectory,
    [(function name, arguments after the tracer, keyword arguments)], and
    the ms of each of ``trajectories`` untraced trajectories after it."""
    from repro_torch import obs
    from repro_torch.bench import sim_scale
    from repro_torch.sim import engine

    eng = engine.Engine(sim_scale._scenario(n_sats), seed=0)

    def trajectory():
        t = 0.0
        for _ in range(2):
            t += eng.run_round(t, sim_scale.MSG).duration
        eng.run_async(0.0, sim_scale.MSG, n_deliveries=100)

    trajectory()                         # warm: plan build, caches, ARQ plans
    calls = []
    names = ("_emit_round_trace", "_emit_async_trace")
    saved = {n: getattr(engine, n) for n in names}
    for n in names:
        setattr(engine, n, lambda trc, *a, _n=n, **k: calls.append((_n, a, k)))
    try:
        obs.enable()
        trajectory()
    finally:
        obs.disable()
        for n, fn in saved.items():
            setattr(engine, n, fn)
    times = []
    for _ in range(trajectories):
        t0 = time.perf_counter()
        trajectory()
        times.append(1e3 * (time.perf_counter() - t0))
    return calls, times


def time_emission(calls, repeats: int, iters: int) -> dict:
    """Least and median ms per trajectory of emitting ``calls`` into a
    fresh tracer, and the digest of what one emission writes."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.sim import engine

    def emit():
        trc = Tracer()
        for name, a, k in calls:
            getattr(engine, name)(trc, *a, **k)
        return trc

    trc = emit()
    stream = json.dumps([trc.events, trc.metrics.to_dict()], sort_keys=True)
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            emit()
        runs.append(1e3 * (time.perf_counter() - t0) / iters)
    n_deliveries = sum(len(a[0].deliveries) if name == "_emit_round_trace" else len(a[0])
                       for name, a, _ in calls)
    return {"ms": min(runs), "median_ms": statistics.median(runs), "runs_ms": runs,
            "deliveries": n_deliveries, "records": len(trc.events),
            "digest": hashlib.sha256(stream.encode()).hexdigest()}


def overhead_calls(n: int) -> dict:
    """``n`` calls of ``bench_trace_overhead()``: every ratio, and the
    breaches of its gate (each call's raise, its message kept)."""
    from repro_torch.bench.sim_scale import bench_trace_overhead
    ratios, breaches = [], []
    for _ in range(n):
        try:
            ratios.append(bench_trace_overhead()["overhead"])
        except AssertionError as e:
            breaches.append(str(e))
    return {"ratios": ratios, "breaches": breaches,
            "max": max(ratios) if ratios else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20,
                    help="calls of bench_trace_overhead() after the emission's time")
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trajectories", type=int, default=0,
                    help="untraced trajectories to time one by one")
    args = ap.parse_args()
    calls, times = capture(trajectories=args.trajectories)
    rec = time_emission(calls, args.repeats, args.iters)
    if times:
        rec["trajectory_ms"] = {"min": min(times), "median": statistics.median(times),
                                "max": max(times), "each": times}
    if args.calls:
        rec["overhead"] = overhead_calls(args.calls)
    rec["host"] = host()
    print(json.dumps(rec))
    return 1 if args.calls and rec["overhead"]["breaches"] else 0


if __name__ == "__main__":
    sys.exit(main())
