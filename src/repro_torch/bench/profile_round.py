"""Profile mega-constellation engine rounds — evidence for perf PRs.

Counterpart of ``benchmarks/profile_round.py`` on the port's simulator
and :mod:`repro_torch.obs.prof`:

    PYTHONPATH=src python -m repro_torch.bench.profile_round           \
        [--scenario mega-1000] [--rounds 3] [--warmup 0] [--seed 0]    \
        [--out profile_round.txt] [--flame profile_round.folded]      \
        [--oracle] [--cprofile] [--check-equivalence]

* the DEFAULT profiler is the deterministic phase-attribution layer
  (:mod:`repro_torch.obs.prof`): rounds run under an in-memory tracer
  and the per-phase self/total/p50/p99 table — with its explicit
  unattributed residual — is printed and (``--out``) written;
  ``--flame`` adds folded stacks for speedscope / flamegraph.pl;
* ``--cprofile`` switches to function-level cProfile (top-25 cumulative
  entries + a raw ``<out>.pstats`` dump for snakeviz), which answers
  "which *function*" when the phase table's "which *stage*" isn't enough;
* engine construction — the one-off cold contact-plan build — stays
  outside the profiled region, matching how ``bench_scale`` accounts it;
* ``--check-equivalence`` first replays the trajectory on the heapq
  oracle (``Engine(fast=False)``) and asserts the fast path's Delivery
  records match field-for-field (exits non-zero on divergence).

The engine is host code: this profiles the host, with no device work.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys

from .. import obs
from ..constellation.links import message_bytes
from ..obs import prof as obs_prof
from ..sim import Engine, get_scenario
from .common import assert_fast_oracle_equivalent

MSG = message_bytes(10000, 10.0)


def check_equivalence(scenario: str, rounds: int, seed: int,
                      async_deliveries: int = 100) -> None:
    """Assert fast == oracle Delivery timelines, sync and async (the
    shared ``assert_fast_oracle_equivalent`` contract — one definition
    for this check and ``sim_scale.bench_fast_round``)."""
    eng_f = Engine(get_scenario(scenario), seed=seed, fast=True)
    eng_o = Engine(get_scenario(scenario), seed=seed, fast=False)
    assert_fast_oracle_equivalent(eng_f, eng_o, MSG, rounds=rounds,
                                  async_deliveries=async_deliveries)
    print(f"equivalence OK: fast == oracle on {scenario!r} "
          f"({rounds} sync rounds + {async_deliveries} async successes, "
          f"seed {seed})")


def _warm(eng, warmup: int) -> float:
    """Run ``warmup`` untraced rounds so one-off costs (lazy imports,
    the first contact-plan extension) stay out of the profiled region."""
    t = 0.0
    for _ in range(warmup):
        t += eng.run_round(t, MSG).duration
    return t


def profile_phases(scenario: str, rounds: int, seed: int,
                   fast: bool = True, warmup: int = 0) -> dict:
    """Run ``rounds`` rounds under an in-memory tracer and return the
    collected phase profile (:func:`repro_torch.obs.prof.collect` shape)."""
    eng = Engine(get_scenario(scenario), seed=seed, fast=fast)
    t = _warm(eng, warmup)
    trc = obs.enable()              # in-memory (path=None)
    try:
        for _ in range(rounds):
            t += eng.run_round(t, MSG).duration
        records = trc.records()
    finally:
        obs.disable()
    return obs_prof.collect(records)


def profile_rounds(scenario: str, rounds: int, seed: int,
                   fast: bool = True, warmup: int = 0) -> pstats.Stats:
    """The ``--cprofile`` path: function-level stats over the rounds."""
    eng = Engine(get_scenario(scenario), seed=seed, fast=fast)
    t = _warm(eng, warmup)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(rounds):
        t += eng.run_round(t, MSG).duration
    prof.disable()
    return pstats.Stats(prof)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench."
                                      "profile_round", description=__doc__)
    ap.add_argument("--scenario", default="mega-1000",
                    help="registered scenario name (default mega-1000)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=0,
                    help="untraced rounds before profiling (keeps one-off "
                         "plan-build/import costs out of the table)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the profile table to FILE (with "
                         "--cprofile also raw pstats to FILE.pstats)")
    ap.add_argument("--flame", default=None, metavar="FILE",
                    help="write folded stacks (speedscope/flamegraph.pl "
                         "input); phase profiler only")
    ap.add_argument("--oracle", action="store_true",
                    help="profile the heapq oracle instead of the fast "
                         "path (before/after comparisons)")
    ap.add_argument("--cprofile", action="store_true",
                    help="function-level cProfile instead of the phase "
                         "profiler")
    ap.add_argument("--check-equivalence", action="store_true",
                    help="assert fast == oracle Delivery timelines before "
                         "profiling")
    args = ap.parse_args(argv)

    if args.check_equivalence:
        check_equivalence(args.scenario, args.rounds, args.seed)

    header = (f"# profile_round --scenario {args.scenario} "
              f"--rounds {args.rounds} --warmup {args.warmup} "
              f"--seed {args.seed}"
              f"{' --oracle' if args.oracle else ''}"
              f"{' --cprofile' if args.cprofile else ''}")

    if args.cprofile:
        stats = profile_rounds(args.scenario, args.rounds, args.seed,
                               fast=not args.oracle, warmup=args.warmup)
        buf = io.StringIO()
        stats.stream = buf
        stats.sort_stats("cumulative").print_stats(25)
        table = buf.getvalue()
        print(table)
        if args.out:
            with open(args.out, "w") as f:
                f.write(header + "\n")
                f.write(table)
            stats.dump_stats(args.out + ".pstats")
            print(f"wrote {args.out} and {args.out}.pstats")
        return 0

    profile = profile_phases(args.scenario, args.rounds, args.seed,
                             fast=not args.oracle, warmup=args.warmup)
    table = obs_prof.render_profile(
        profile, title=f"{args.scenario} "
                       f"[{'oracle' if args.oracle else 'fast'}] "
                       f"{args.rounds} sync round(s)")
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(header + "\n")
            f.write(table + "\n")
        print(f"wrote {args.out}")
    if args.flame:
        with open(args.flame, "w") as f:
            f.write(obs_prof.folded(profile))
        print(f"wrote {args.flame} (folded stacks — load in "
              f"https://speedscope.app)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
