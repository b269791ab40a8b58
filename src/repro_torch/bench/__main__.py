"""CLI: run the benchmark registry and emit BENCH_*.json.

The port's ``python -m repro.bench``; it runs on the card:

    python -m repro_torch.bench --tiny --emit bench_out/   # gate-sized run
    python -m repro_torch.bench --emit src/repro_torch/bench/baseline --no-trace
                                                           # refresh baselines
    python -m repro_torch.bench --list
    python -m repro_torch.bench --only sim.round_pipeline
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..device import device_label, resolve_device
from .registry import BENCHMARKS, run_benchmarks

SCHEMA_VERSION = 1


def emit(results, directory: str, tiny: bool, device: str) -> None:
    """Write one ``BENCH_<group>.json`` per group into ``directory``: the
    JAX package's ``schema``, ``tiny`` and ``benchmarks``, plus
    ``device`` (:func:`device_label` of the run's device)."""
    os.makedirs(directory, exist_ok=True)
    for group, benches in results.items():
        path = os.path.join(directory, f"BENCH_{group}.json")
        with open(path, "w") as f:
            json.dump({"schema": SCHEMA_VERSION, "tiny": tiny,
                       "device": device, "benchmarks": benches}, f,
                      indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")


def emit_trace(directory: str) -> str:
    """Capture a mega-1000 obs trace next to the BENCH files.

    A dedicated post-bench pass — tracing is never enabled inside the
    timed bench regions, where buffering would perturb the gated ratios.
    ``python -m repro_torch.obs check`` reads the result (bytes
    conservation + ordering).  The same trajectory is also traced on the
    heapq oracle, so ``python -m repro_torch.obs perfdiff`` can say where
    the fast path spends its time against it, and the trace is folded
    into ``ledger.jsonl`` beside the BENCH files.  The engine is host
    code; no device is involved.
    """
    from .. import obs
    from ..constellation.links import message_bytes
    from ..obs.ledger import ingest
    from ..sim import Engine, get_scenario

    path = os.path.join(directory, "TRACE_mega-1000.jsonl")
    eng = Engine(get_scenario("mega-1000"))
    msg = message_bytes(10000, 10.0)
    with obs.tracing(path, scenario="mega-1000", source="repro_torch.bench"):
        t = 0.0
        for _ in range(2):
            t += eng.run_round(t, msg).duration
        eng.run_async(0.0, msg, n_deliveries=50)
    print(f"wrote {path}")
    o_path = os.path.join(directory, "TRACE_mega-1000-oracle.jsonl")
    o_eng = Engine(get_scenario("mega-1000"), fast=False)
    with obs.tracing(o_path, scenario="mega-1000", source="repro_torch.bench",
                     engine="oracle"):
        t = 0.0
        for _ in range(2):
            t += o_eng.run_round(t, msg).duration
        o_eng.run_async(0.0, msg, n_deliveries=50)
    print(f"wrote {o_path}")
    ledger = os.path.join(directory, "ledger.jsonl")
    entry, added = ingest(path, ledger)
    print(f"{'ingested into' if added else 'already present in'} "
          f"{ledger} as {entry['run_id']}")
    return path


def main(argv=None, device=None) -> int:
    """The CLI; ``device`` (the card unless ``"cpu"``) is for callers in
    Python, such as the tests."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="gate-sized run (strict metric subset of the full "
                         "run)")
    ap.add_argument("--emit", metavar="DIR", default=None,
                    help="write BENCH_<group>.json files into DIR")
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these registered benchmarks")
    ap.add_argument("--list", action="store_true",
                    help="list registered benchmarks and exit")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the post-bench mega-1000 obs trace capture "
                         "(TRACE_mega-1000.jsonl next to the BENCH files)")
    args = ap.parse_args(argv)

    if args.list:
        for name, b in sorted(BENCHMARKS.items()):
            print(f"{name:28s} [{b.group}] {b.description}")
        return 0

    dev = resolve_device(device)
    results = run_benchmarks(args.only, tiny=args.tiny, device=dev)
    if args.emit:
        emit(results, args.emit, args.tiny, device_label(dev))
        if not args.no_trace:
            emit_trace(args.emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
