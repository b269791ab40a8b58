"""Named benchmark registry wrapping the port's benchmark entry points.

Counterpart of ``repro.bench.registry``, with its seven benchmarks under
the same names, groups and metrics.  Each benchmark is a function
``fn(tiny: bool, device: torch.device) -> {metric: metric_dict}``
registered under ``"<group>.<name>"``; groups map to emitted files
(``sim`` → ``BENCH_sim.json``, ``kernels`` → ``BENCH_kernels.json``).
:func:`run_benchmarks` resolves the device once (the card unless the
caller passes ``device="cpu"``) and hands it to every benchmark.  The
kernel benchmarks run :mod:`repro_torch.kernels.ops`: the CUDA kernels on
the card, their plain versions on the CPU.  The engine benchmarks are
host code on either.

Metric schema (one dict per metric, see :func:`metric`):

    {"value": float, "unit": str, "higher_is_better": bool, "gate": bool}

``gate=True`` marks metrics the perf gate enforces against the
committed baseline (±tolerance, see :mod:`repro_torch.bench.compare`).
Only machine-independent RATIOS (fused-vs-unfused speedups) gate;
absolute wall-clock and throughput numbers are recorded as the perf
trajectory but do not fail the gate, since the baseline and a later run
may be different machines.

The ``--tiny`` metric set is a strict subset of the full set (same metric
names at the shared scales), so a tiny run always finds its gated
metrics in a full-run baseline.

Unlike the JAX package's registry, a benchmark that raises fails the
run: every benchmark imports from this package, so there is no
``ImportError`` to skip.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..device import resolve_device

BENCHMARKS: Dict[str, "Benchmark"] = {}


@dataclasses.dataclass(frozen=True)
class Benchmark:
    name: str                       # "<group>.<name>"
    group: str                      # "sim" | "kernels" | custom
    fn: Callable[[bool, torch.device], Dict[str, dict]]
    description: str = ""


def metric(value: float, unit: str, *, higher_is_better: bool,
           gate: bool = False) -> dict:
    """One recorded measurement (see module docstring for the schema)."""
    return {"value": float(value), "unit": unit,
            "higher_is_better": bool(higher_is_better), "gate": bool(gate)}


def register_benchmark(name: str, group: str, description: str = ""):
    """Decorator: register ``fn(tiny, device) -> {metric: metric_dict}``."""
    def deco(fn):
        BENCHMARKS[name] = Benchmark(name, group, fn, description)
        return fn
    return deco


def run_benchmarks(names: Optional[List[str]] = None, *, tiny: bool = False,
                   verbose: bool = True, device=None
                   ) -> Dict[str, Dict[str, Dict[str, dict]]]:
    """Run (a subset of) the registry on ``device`` (the card unless
    ``"cpu"``); returns {group: {bench: metrics}}."""
    dev = resolve_device(device)
    selected = sorted(BENCHMARKS) if names is None else names
    unknown = [n for n in selected if n not in BENCHMARKS]
    if unknown:
        raise KeyError(f"unknown benchmark(s) {unknown}; "
                       f"known: {sorted(BENCHMARKS)}")
    out: Dict[str, Dict[str, Dict[str, dict]]] = {}
    for name in selected:
        b = BENCHMARKS[name]
        if verbose:
            print(f"# {b.name}: {b.description}")
        metrics = b.fn(tiny, dev)
        out.setdefault(b.group, {})[b.name] = metrics
        if verbose:
            for m, d in sorted(metrics.items()):
                g = " [gate]" if d["gate"] else ""
                print(f"  {m:40s} {d['value']:12.4f} {d['unit']}{g}")
    return out


# ---------------------------------------------------------------------------
# Built-in benchmarks: the kernels through kernels.ops, the simulator
# through this package's sim_scale.
# ---------------------------------------------------------------------------

@register_benchmark(
    "kernels.pack_throughput", "kernels",
    "transposed bit-plane pack/unpack value-side throughput (the CUDA "
    "kernels on the card)")
def _pack_throughput(tiny: bool, device) -> Dict[str, dict]:
    from ..kernels import ops, ref
    from .timing import gbps, time_fn
    sizes = [1 << 16] if tiny else [1 << 16, 1 << 20]
    out: Dict[str, dict] = {}
    for n in sizes:
        gen = torch.Generator().manual_seed(0)
        x = ref.to_uint32(torch.randint(0, 255, (n,), generator=gen)
                          .to(device))
        words = ops.pack_bits(x, 8)
        t_pack = time_fn(lambda: ops.pack_bits(x, 8))
        t_unpack = time_fn(lambda: ops.unpack_bits(words, 8, n))
        out[f"pack_gbps_n{n}"] = metric(gbps(4 * n, t_pack), "GB/s",
                                        higher_is_better=True)
        out[f"unpack_gbps_n{n}"] = metric(gbps(4 * n, t_unpack), "GB/s",
                                          higher_is_better=True)
    return out


@register_benchmark(
    "kernels.fused_pipeline", "kernels",
    "fused quantize→EF→pack sweep vs separate quantize_ef + pack_bits")
def _fused_pipeline(tiny: bool, device) -> Dict[str, dict]:
    from ..kernels import ops
    from .timing import time_pair
    sizes = [1 << 18] if tiny else [1 << 18, 1 << 20]
    out: Dict[str, dict] = {}
    for n in sizes:
        gen = torch.Generator().manual_seed(0)
        x = (torch.randn(n, generator=gen) * 0.3).to(device)
        z = torch.zeros(n, device=device)

        def unfused():
            w, c = ops.quantize_ef(x, z, levels=255, vmin=-1.0, vmax=1.0)
            return ops.pack_bits(w, 8), c

        def fused():
            return ops.quant_pipeline(x, z, levels=255, vmin=-1.0, vmax=1.0)

        t_u, t_f = time_pair(unfused, fused, reps=9)
        out[f"unfused_ms_n{n}"] = metric(t_u * 1e3, "ms",
                                         higher_is_better=False)
        out[f"fused_ms_n{n}"] = metric(t_f * 1e3, "ms",
                                       higher_is_better=False)
        # gate only the size the tiny run measures; the larger size rides
        # along informationally
        out[f"speedup_n{n}"] = metric(t_u / t_f, "x", higher_is_better=True,
                                      gate=(n == 1 << 18))
    return out


@register_benchmark(
    "sim.round_pipeline", "sim",
    "end-to-end sync round: cohort-batched fused uplink vs per-satellite "
    "quantize_ef→pack_bits dispatch chain")
def _sim_round_pipeline(tiny: bool, device) -> Dict[str, dict]:
    from .sim_scale import bench_round_pipeline
    # mega-1000 runs even in the tiny set: its fused-vs-unfused ratio is
    # the gated claim; the 64-sat ratio stays informational
    scales = [64, 1000]
    out: Dict[str, dict] = {}
    for n in scales:
        r = bench_round_pipeline(n, rounds=3, device=device)
        p = f"n{n}_"
        out[p + "round_s_unfused"] = metric(r["round_s_unfused"], "s/round",
                                            higher_is_better=False)
        out[p + "round_s_fused"] = metric(r["round_s_fused"], "s/round",
                                          higher_is_better=False)
        out[p + "speedup"] = metric(r["speedup"], "x", higher_is_better=True,
                                    gate=(n == 1000))
        out[p + "sats_per_sec"] = metric(r["sats_per_sec_fused"], "sats/s",
                                         higher_is_better=True)
    return out


@register_benchmark(
    "sim.lossy_round", "sim",
    "stochastic lossy-channel round: ARQ/erasure engine overhead vs the "
    "lossless path, plus on-device lossy uplink transport (fused "
    "quant_pipeline→erasure_mask vs the unfused three-dispatch chain)")
def _sim_lossy_round(tiny: bool, device) -> Dict[str, dict]:
    from .sim_scale import bench_lossy_round
    # like sim.round_pipeline, the 1000-sat scenario runs even in the tiny
    # set: its fused-vs-unfused lossy-uplink ratio is the gated claim
    scales = [64, 1000]
    out: Dict[str, dict] = {}
    for n in scales:
        r = bench_lossy_round(n, rounds=3, device=device)
        p = f"n{n}_"
        out[p + "round_s_lossless"] = metric(r["round_s_lossless"],
                                             "s/round",
                                             higher_is_better=False)
        out[p + "round_s_lossy"] = metric(r["round_s_lossy"], "s/round",
                                          higher_is_better=False)
        # host-side ARQ + counter-hash cost; informational — it depends on
        # how many deliveries the trajectory happens to contain
        out[p + "channel_overhead"] = metric(r["channel_overhead"], "x",
                                             higher_is_better=False)
        out[p + "lossy_uplink_speedup"] = metric(
            r["lossy_uplink_speedup"], "x", higher_is_better=True,
            gate=(n == 1000))
        out[p + "lost_frac"] = metric(
            r["lost"] / max(r["attempted"], 1), "frac",
            higher_is_better=False)
    return out


@register_benchmark(
    "sim.fast_round", "sim",
    "vectorized batch-event core vs the heapq oracle: Delivery-timeline "
    "equivalence asserted bit-for-bit, then warm sync/async wall-clock "
    "ratios on mega-1000")
def _sim_fast_round(tiny: bool, device) -> Dict[str, dict]:
    from .sim_scale import bench_fast_round
    # mega-1000 runs even in the tiny set: the async fast-vs-oracle ratio
    # is the gated claim; the sync ratio stays informational
    r = bench_fast_round(1000, rounds=3)
    # the raw async ratio is large but volatile, so the GATED metric caps
    # it at 10x: any healthy run saturates the cap and compares 1.0
    # against the baseline, while a real regression lands far below
    # 10·(1−tol) and still fails the gate.  The raw ratio rides along.
    return {
        "n1000_round_s_fast": metric(r["round_s_fast"], "s/round",
                                     higher_is_better=False),
        "n1000_round_s_oracle": metric(r["round_s_oracle"], "s/round",
                                       higher_is_better=False),
        "n1000_sync_speedup": metric(r["sync_speedup"], "x",
                                     higher_is_better=True),
        "n1000_async_speedup": metric(r["async_speedup"], "x",
                                      higher_is_better=True),
        "n1000_async_speedup_capped": metric(
            min(r["async_speedup"], 10.0), "x", higher_is_better=True,
            gate=True),
    }


@register_benchmark(
    "sim.trace_overhead", "sim",
    "repro_torch.obs structured tracing on mega-1000 sync+async rounds: "
    "enabled-vs-disabled wall-clock ratio (<5% hard-asserted)")
def _sim_trace_overhead(tiny: bool, device) -> Dict[str, dict]:
    from .sim_scale import bench_trace_overhead
    # mega-1000 runs even in the tiny set: the overhead ratio IS the
    # claim.  Lower is better, baseline ~1.0x, so the ±20% gate trips well
    # before emission cost could creep toward the hot loops.
    r = bench_trace_overhead(1000, rounds=2)
    return {
        "n1000_s_disabled": metric(r["s_disabled"], "s",
                                   higher_is_better=False),
        "n1000_s_enabled": metric(r["s_enabled"], "s",
                                  higher_is_better=False),
        "n1000_overhead": metric(r["overhead"], "x", higher_is_better=False,
                                 gate=True),
        "n1000_events": metric(r["events"], "events",
                               higher_is_better=True),
    }


@register_benchmark(
    "sim.engine_scale", "sim",
    "discrete-event engine throughput (cold plan build + sync rounds + "
    "async deliveries) at 100/1000/10000-satellite scale")
def _sim_engine_scale(tiny: bool, device) -> Dict[str, dict]:
    from .sim_scale import bench_scale
    scales = [100] if tiny else [100, 1000, 10000]
    out: Dict[str, dict] = {}
    for n in scales:
        rounds = 3
        r = bench_scale(n, rounds=rounds, async_deliveries=100)
        p = f"n{n}_"
        out[p + "sync_sats_per_sec"] = metric(
            r["sync_active"] / max(r["sync_s"], 1e-9), "sats/s",
            higher_is_better=True)
        out[p + "round_s"] = metric(r["sync_s"] / rounds, "s/round",
                                    higher_is_better=False)
        out[p + "async_deliveries_per_sec"] = metric(
            r["async_n"] / max(r["async_s"], 1e-9), "deliveries/s",
            higher_is_better=True)
    return out
