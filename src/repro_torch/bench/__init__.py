"""The port's benchmarks: the paper's tables and figure, the simulator's
and kernels' benchmarks, and the performance harness over them.

The harness is the JAX package's ``repro.bench``, run on the card:

  * ``python -m repro_torch.bench --emit src/repro_torch/bench/baseline
    --no-trace`` runs the registered benchmarks and (re)writes the port's
    baselines — pack GB/s, fused-vs-unfused speedups, engine throughput
    and round times at 100/1000/10000-satellite scale;
  * ``python -m repro_torch.bench --tiny --emit bench_out/`` is the
    gate-sized run (a strict subset of the full metric set);
  * ``python -m repro_torch.bench.compare bench_out`` checks a fresh run
    against the port's baselines with a ±20% tolerance on gated metrics
    (machine-independent ratios; absolute times are informational) and
    exits non-zero on regression.

The root ``BENCH_sim.json`` / ``BENCH_kernels.json`` are the JAX
package's CPU baselines; the port never writes or compares against them.
Register your own with :func:`repro_torch.bench.registry.register_benchmark`.
"""
from .registry import (BENCHMARKS, Benchmark, metric, register_benchmark,
                       run_benchmarks)
from .timing import time_fn

__all__ = ["BENCHMARKS", "Benchmark", "metric", "register_benchmark",
           "run_benchmarks", "time_fn"]
