"""Benchmark runner: one function per paper table and figure.

Counterpart of the JAX package's ``benchmarks/run.py``, with the sections
the port has: Table 1, the lossy-channel and fault-tolerance tables,
Fig. 4 and Table 2.  Prints
``name,us_per_call,derived`` CSV lines.  ``--full`` runs the paper-scale
versions (minutes); the default quick mode checks the same qualitative
claims at reduced scale.  Runs on the card.

    PYTHONPATH=src python -m repro_torch.bench.run [--full]
"""
from __future__ import annotations

import argparse
import sys
import traceback


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    args, _ = ap.parse_known_args()
    quick = not args.full

    failures = []

    def section(name, fn):
        print(f"\n# --- {name} ---")
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failures.append(name)

    from . import fig4_trajectory, table1_error_feedback, table2_space_comparison
    from . import table_fault_tolerance, table_lossy_ef

    section("Table 1: error feedback ablation",
            lambda: table1_error_feedback.main(quick=quick))
    section("Lossy-channel table: loss-robust EF vs naive EF vs no EF",
            lambda: table_lossy_ef.main(quick=quick))
    section("Fault-tolerance table: quorum+failover+robust-EF vs naive restart",
            lambda: table_fault_tolerance.main(quick=quick))
    section("Fig 4: error trajectory",
            lambda: fig4_trajectory.main(quick=quick))
    section("Table 2: constellation comparison",
            lambda: table2_space_comparison.main(quick=quick))

    if failures:
        print("\nFAILED sections:", failures)
        sys.exit(1)
    print("\nall benchmark sections completed")


if __name__ == "__main__":
    main()
