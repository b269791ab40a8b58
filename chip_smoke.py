#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/``, then, each phase failing the run:

1. prints the card's name and power limit (``nvidia-smi``) and the
   compiler's register counts;
2. holds every kernel against its plain PyTorch version on the card, word
   for word and bit for bit, at the main path's shapes, at a ragged shape
   of several tiles and at 2**24 values, on inputs that include exact
   half-level boundaries, out-of-range values and -0.0;
3. runs paper Table 1's "quant L=10 ±1 / Algorithm 2 (EF)" arm of Fed-LT at
   paper size (N=100 agents, m=500, d=100, ε=50; N_e=10, γ=0.005, ρ=20;
   fused uplink) for 300 rounds, printing e_K every 50 rounds, and checks
   that e_K is finite and falls, that the kernels ran once per round, and
   that one round's uplink through the kernel equals its plain version;
4. encodes one agent's uplink with the wire codec and decodes it back;
5. times each kernel with CUDA events beside its bound and its plain
   version, at the main path's shape and at 2**24 values.

The launch counts are zeroed just before phases 3 and 4 (the main path)
and read just after.  Then it prints one JSON line with a record per
kernel and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with an error and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
PAPER = dict(n_agents=100, m=500, dim=100)   # benchmarks/common.py PAPER, ε=50
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
MAIN_N = 100 * 100            # the fused uplink: (N, d) = (100, 100)
AGENT_N = 100                 # one agent's uplink, d = 100
BIG_N = 2**24
SIZES = (MAIN_N, 70_001, BIG_N)
BITS = (1, 4, 8, 13, 32)
QUANT_CONFIGS = ((10, -1.0, 1.0), (10, -10.0, 10.0), (255, -1.0, 1.0),
                 (255, -10.0, 10.0), (1023, -1.0, 1.0), (1023, -10.0, 10.0))
ROUND_CHUNKS = (1, 49, 50, 50, 50, 50, 49, 1)     # 300 rounds, e_K at 1, 50, …
TOL = "exact: words equal word for word, new caches equal bit for bit"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns (uint32 words, or floats including signed zeros)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def int_err(a: torch.Tensor, b: torch.Tensor) -> float:
    from repro_torch.kernels.ref import as_int64
    return float((as_int64(a) - as_int64(b)).abs().max())


# -- phase 1 ---------------------------------------------------------------

def phase_build() -> str:
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"[build] {len(paths)} libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    return smi


# -- phase 2 ---------------------------------------------------------------

def quant_inputs(n: int, levels: int, vmin: float, vmax: float, rng):
    """msg and cache with exact half-level boundaries, their neighbours,
    out-of-range values and signed zeros at the front (cache 0 there, so
    msg + cache keeps them exact)."""
    delta = (vmax - vmin) / levels
    half = (vmin + (np.arange(levels) + 0.5) * delta).astype(np.float32)
    special = np.concatenate([
        half, np.nextafter(half, np.float32(np.inf)),
        np.nextafter(half, np.float32(-np.inf)),
        np.array([vmin, vmax, -0.0, 0.0, 3 * vmin, 3 * vmax, vmin - delta,
                  vmax + delta, np.nextafter(np.float32(vmax), np.float32(0))],
                 np.float32)])
    msg = rng.uniform(1.25 * vmin, 1.25 * vmax, n).astype(np.float32)
    cache = rng.uniform(-delta, delta, n).astype(np.float32)
    k = min(n, special.size)
    msg[:k] = special[:k]
    cache[:k] = np.where(np.arange(k) % 2 == 0, np.float32(0.0), np.float32(-0.0))
    return torch.from_numpy(msg).to(DEV), torch.from_numpy(cache).to(DEV)


def phase_kernels(rng) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import pack_bits, unpack_bits
    err = {"pack_bits": 0.0, "unpack_bits": 0.0, "quant_pipeline": 0.0}
    for n in (AGENT_N,) + SIZES:
        for bits in BITS:
            hi = 2**bits
            vals = torch.from_numpy(rng.integers(0, hi, n, dtype=np.uint64)
                                    .astype(np.uint32)).to(DEV)
            words = pack_bits(vals, bits)
            words_p = ref.pack_bits_ref(vals, bits)
            check(same_bits(words, words_p), f"pack_bits n={n} b={bits} differs "
                  "from its plain version")
            err["pack_bits"] = max(err["pack_bits"], int_err(words, words_p))
            back = unpack_bits(words, bits, n)
            back_p = ref.unpack_bits_ref(words, bits, n)
            check(same_bits(back, back_p) and same_bits(back, vals),
                  f"unpack_bits n={n} b={bits} differs from its plain version "
                  "or does not invert pack_bits")
            err["unpack_bits"] = max(err["unpack_bits"], int_err(back, back_p))
        print(f"[kernels] pack_bits/unpack_bits n={n} b={BITS}: {TOL}")
    for n in SIZES:
        for levels, vmin, vmax in QUANT_CONFIGS:
            msg, cache = quant_inputs(n, levels, vmin, vmax, rng)
            words, newc = quant_pipeline(msg, cache, levels=levels, vmin=vmin,
                                         vmax=vmax)
            words_p, newc_p = ref.quant_pipeline_ref(msg, cache, levels=levels,
                                                     vmin=vmin, vmax=vmax)
            check(same_bits(words, words_p) and same_bits(newc, newc_p),
                  f"quant_pipeline n={n} L={levels} ±{vmax} differs from its "
                  "plain version")
            err["quant_pipeline"] = max(err["quant_pipeline"],
                                        int_err(words, words_p),
                                        float((newc - newc_p).abs().max()))
        print(f"[kernels] quant_pipeline n={n} (L, vmin, vmax) in "
              f"{QUANT_CONFIGS}: {TOL}")
    torch.cuda.synchronize()
    return err


# -- phases 3 and 4: the main path -----------------------------------------

def phase_fedlt():
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.core.error_feedback import EFChannel
    from repro_torch.core.fedlt import FedLT, optimality_error
    from repro_torch.data.logistic import generate, make_local_loss, solve_global
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    n_agents, dim = PAPER["n_agents"], PAPER["dim"]
    data, _ = generate(0, **PAPER, device=DEV)
    loss = make_local_loss(eps=50.0, n_agents=n_agents)
    xbar = solve_global(data, eps=50.0)
    quant = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    alg = FedLT(loss=loss, n_epochs=10, gamma=0.005, rho=20.0,
                uplink=EFChannel(quant), downlink=EFChannel(quant),
                fused_uplink=True)
    state = alg.init(torch.zeros(dim, device=DEV), n_agents)
    torch.cuda.synchronize()
    print(f"[fedlt] set-up (data, x̄ by Newton) {time.perf_counter() - t0:.2f} s")

    e_k, chunk_ms = {}, {}
    wall = 0.0
    for chunk in ROUND_CHUNKS:
        before = state
        t0 = time.perf_counter()
        state, info = alg.run(state, data, chunk)
        e_k[state.k] = float(optimality_error(state.x, xbar))   # synchronizes
        dt = time.perf_counter() - t0
        wall += dt
        chunk_ms[state.k] = 1e3 * dt / chunk
        check(int(info["n_active"].min()) == n_agents, "participation 1.0 "
              "left an agent out")
    rounds = state.k
    for k, e in e_k.items():
        if k == 1 or k % 50 == 0:
            print(f"[fedlt] round {k:3d}  e_K = {e:.6e}   "
                  f"({chunk_ms[k]:.2f} ms per round in the rounds up to here)")
    print(f"[fedlt] {rounds} rounds in {wall:.2f} s ({1e3 * wall / rounds:.2f} ms "
          "per round; host clock around work ending in a synchronize)")
    check(all(math.isfinite(e) for e in e_k.values()), "e_K is not finite")
    check(e_k[rounds] < e_k[1], f"e_K did not fall: {e_k[1]} -> {e_k[rounds]}")
    counts = ops.launch_counts()
    check(counts["quant_pipeline"] == rounds and counts["unpack_bits"] == rounds
          and counts["pack_bits"] == 0,
          f"expected one quant_pipeline and one unpack_bits launch per round "
          f"({rounds}), got {counts}")
    print(f"[fedlt] launches over {rounds} rounds: {counts}")
    return alg, data, state, before


def phase_wire(state):
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.kernels.pack_bits import logical_words
    from repro_torch.wire.message import MESSAGE_HEADER_NBYTES

    codec = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True).wire_codec()
    uplink = state.z_hat[0]                  # agent 0's last uplink wire
    msg = codec.encode(uplink)
    d = uplink.numel()
    expect = (MESSAGE_HEADER_NBYTES + codec.leaf_header_nbytes(1)
              + 4 * logical_words(d, 4))
    check(msg.nbytes == expect, f"wire nbytes {msg.nbytes} != {expect}")
    check(same_bits(codec.decode(msg), uplink), "wire decode is not bit-exact")
    print(f"[wire] agent 0's uplink: {msg.nbytes} bytes on the wire "
          f"(= 8 + {codec.leaf_header_nbytes(1)} + 4·{logical_words(d, 4)}), "
          "decoded bit-exact")


def check_captured_round(state, before):
    """The last round's uplink inputs, through kernel and plain version."""
    from repro_torch.core.compression import quantize_decode
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import unpack_bits
    z_next, c_up = state.z, before.c_up      # every agent active
    words, newc = quant_pipeline(z_next, c_up, levels=10, vmin=-1.0, vmax=1.0)
    words_p, newc_p = ref.quant_pipeline_ref(z_next, c_up, levels=10,
                                             vmin=-1.0, vmax=1.0)
    check(same_bits(words, words_p) and same_bits(newc, newc_p),
          "captured round: kernel and plain version differ")
    check(same_bits(newc, state.c_up), "captured round: the kernel does not "
          "reproduce the run's new uplink cache")
    wire = quantize_decode(unpack_bits(words, 4, z_next.numel()), 10, -1.0,
                           1.0).reshape(z_next.shape)
    check(same_bits(wire, state.z_hat), "captured round: the decoded wire is "
          "not the run's z_hat")
    print(f"[fedlt] round {state.k} uplink (z_next, c_up) {tuple(z_next.shape)}: "
          f"kernel == plain version bit for bit, and == the run's c_up, z_hat")


def check_small_against_cpu():
    """The same small problem on the CPU (plain versions) and on the card."""
    from repro_torch.core.compression import UniformQuantizer
    from repro_torch.core.error_feedback import EFChannel
    from repro_torch.core.fedlt import FedLT, optimality_error
    from repro_torch.data.logistic import generate, make_local_loss, solve_global
    from repro_torch.core.pytree import tree_map

    data, _ = generate(1, n_agents=8, m=16, dim=8, device="cpu")
    quant = UniformQuantizer(levels=10, vmin=-1.0, vmax=1.0, clip=True)
    alg = FedLT(loss=make_local_loss(50.0, 8), n_epochs=10, gamma=0.005, rho=20.0,
                uplink=EFChannel(quant), downlink=EFChannel(quant),
                fused_uplink=True)
    active = np.random.default_rng(3).random((20, 8)) < 0.7
    active[:, 0] = True
    e = {}
    for dev in ("cpu", DEV):
        d = tree_map(lambda t: t.to(dev), data)
        xbar = solve_global(d, eps=50.0)
        st, _ = alg.run(alg.init(torch.zeros(8, device=dev), 8), d, 20,
                        active=active)
        e[dev] = float(optimality_error(st.x, xbar))
    rel = abs(e[DEV] - e["cpu"]) / e["cpu"]
    # matmul summation order differs between CPU and card
    check(rel < 1e-4, f"small run: e_K on the card {e[DEV]} vs CPU {e['cpu']}")
    print(f"[fedlt] small run (N=8, 20 rounds, partial participation): e_K card "
          f"{e[DEV]:.6e} vs CPU {e['cpu']:.6e} (rel {rel:.1e} < 1e-4)")


def phase_profile(alg, data, state, rounds: int = 5) -> None:
    """Where a round's time goes: torch.profiler over a few rounds, device
    time summed by kernel, beside the wall time of the same rounds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        alg.run(state, data, rounds)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / rounds
    device = [e for e in prof.key_averages() if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / rounds
    launches = sum(e.count for e in device) / rounds
    print(f"[profile] {rounds} rounds under torch.profiler: wall {wall_ms:.3f} ms "
          f"per round, device busy {busy_ms:.3f} ms per round "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} device ops per round")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / rounds:8.4f} ms/round "
              f"{e.count / rounds:6.0f}x/round "
              f"{e.self_device_time_total / e.count:8.2f} us each  {e.key[:70]}")
    ours = {f"{name}_kernel": name for name in SOURCES}
    for e in device:
        name = ours.get(e.key.split("(")[0].split()[-1])
        if name:
            print(f"[profile] {name}: {e.self_device_time_total / e.count:.2f} us "
                  f"of device time per launch, {e.count / rounds:.0f}x/round")


# -- phase 5 ---------------------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean time per call from CUDA events around ``iters`` back-to-back
    calls (host launch cost included when it exceeds the kernel's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(rng) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    from repro_torch.kernels.pack_bits import n_tiles, pack_bits, unpack_bits
    out = {}
    bits = 4
    shapes = {"pack_bits": AGENT_N, "unpack_bits": MAIN_N, "quant_pipeline": MAIN_N}
    for name, main_n in shapes.items():
        for n in (main_n, BIG_N):
            iters = 200 if n < BIG_N else 20
            word_bytes = 4 * n_tiles(n) * bits * 1024
            bit_ops = 4 * bits * n           # shift, and, shift, or per bit
            if name == "pack_bits":
                vals = torch.from_numpy(rng.integers(0, 2**bits, n).astype(np.uint32)).to(DEV)
                kern = lambda: pack_bits(vals, bits)
                plain = lambda: ref.pack_bits_ref(vals, bits)
                nbytes, ops = 4 * n + word_bytes, bit_ops
            elif name == "unpack_bits":
                words = pack_bits(torch.from_numpy(
                    rng.integers(0, 2**bits, n).astype(np.uint32)).to(DEV), bits)
                kern = lambda: unpack_bits(words, bits, n)
                plain = lambda: ref.unpack_bits_ref(words, bits, n)
                nbytes, ops = word_bytes + 4 * n, bit_ops
            else:
                msg, cache = quant_inputs(n, 10, -1.0, 1.0, rng)
                kern = lambda: quant_pipeline(msg, cache, levels=10, vmin=-1.0, vmax=1.0)
                plain = lambda: ref.quant_pipeline_ref(msg, cache, levels=10,
                                                       vmin=-1.0, vmax=1.0)
                nbytes, ops = 12 * n + word_bytes, 12 * n + bit_ops
            plain_ms = time_ms(plain, iters)
            ms = time_ms(kern, iters)
            ms2 = time_ms(kern, iters)
            plain_ms2 = time_ms(plain, iters)
            b_ms, b_by = bound(nbytes, ops)
            rec = {"n": n, "bits": bits, "ms": min(ms, ms2),
                   "plain_ms": min(plain_ms, plain_ms2), "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes, "ops": ops,
                   "ms_runs": [ms, ms2], "plain_ms_runs": [plain_ms, plain_ms2]}
            out.setdefault(name, []).append(rec)
            print(f"[times] {name:15s} n={n:9d} b={bits}: kernel {rec['ms']:.5f} ms "
                  f"(runs {ms:.5f}, {ms2:.5f}), plain {rec['plain_ms']:.5f} ms, "
                  f"bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {ops} ops); "
                  "library: none, no single PyTorch call computes it")
    return out


SOURCES = {
    "pack_bits": ("src/repro_torch/kernels/csrc/pack_bits.cu",
                  "src/repro/kernels/pack_bits.py:80"),
    "unpack_bits": ("src/repro_torch/kernels/csrc/pack_bits.cu",
                    "src/repro/kernels/pack_bits.py:107"),
    "quant_pipeline": ("src/repro_torch/kernels/csrc/quant_pipeline.cu",
                       "src/repro/kernels/compress_pipeline.py:112"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import ops

    repro_torch.set_float32_precision()
    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    phase_build()
    errors = phase_kernels(rng)

    ops.reset_launch_counts()            # the main path: phases 3 and 4
    alg, data, state, before = phase_fedlt()
    phase_wire(state)
    launches = ops.launch_counts()
    print(f"[main path] launches: {launches}")
    check(all(launches[k] > 0 for k in SOURCES), f"a kernel of the path never "
          f"launched: {launches}")

    check_captured_round(state, before)
    check_small_against_cpu()
    phase_profile(alg, data, state)
    times = phase_times(rng)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        main_rec, big_rec = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": None, "n": main_rec["n"], "bits": main_rec["bits"],
            "at_2p24": {k: big_rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")}})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
