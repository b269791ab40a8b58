"""Roofline aggregation: results/torch/dryrun/*.json → a markdown table.

Counterpart of the JAX package's ``benchmarks/roofline.py``, over the
port's dry-run records (``python -m repro_torch.launch.dryrun``; written
by :mod:`.dryrun_all`).  Per (arch × shape), single-pod mesh:

  * exact totals via linear extrapolation from the unrolled R=1/R=2 runs:
        cost(R) = base + R·unit  ⇒  total = c1 + (R_real − 1)·(c2 − c1)
    (the per-device counts are linear in depth in the port too: each
    scan repeat dispatches the same ops);
  * the three roofline terms (per-device seconds) at the H100's rates
    (``launch.dryrun``'s constants), the dominant bottleneck, the
    MODEL_FLOPS ratio, and the production run's memory fits-check against
    one card's memory.
"""
from __future__ import annotations

import json
import os

from ..configs import ARCHS
from ..launch.dryrun import HBM_BW, NVLINK_BW, PEAK_FLOPS

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                       "torch", "dryrun")

# torch.cuda.get_device_properties(0).total_memory on the card that
# `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` names
# "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_PER_CHIP = 85_017_493_504

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _load(name):
    path = os.path.join(OUT_DIR, name + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def extrapolate(arch, shape):
    """Exact per-device totals at real depth from the R=1/R=2 unrolled runs."""
    c1 = _load(f"{arch}__{shape}__single__unroll1")
    c2 = _load(f"{arch}__{shape}__single__unroll2")
    prod = _load(f"{arch}__{shape}__single")
    if not prod or "skipped" in prod:
        return prod
    if not c1 or not c2 or "skipped" in c1:
        return None
    r_real = ARCHS[arch].scan_repeats

    def ext(key):
        u = c2[key] - c1[key]
        return c1[key] + (r_real - 1) * u

    flops = ext("hlo_flops_per_chip")
    byts = ext("hlo_bytes_per_chip")
    coll = ext("collective_bytes_total")
    res = dict(prod)
    res.update(
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=byts,
        collective_bytes_total=coll,
        t_compute=flops / PEAK_FLOPS,
        t_memory=byts / HBM_BW,
        t_collective=coll / NVLINK_BW,
        useful_flops_ratio=(prod["model_flops"] / (flops * prod["n_chips"])
                            if flops else None),
        extrapolated=True,
    )
    terms = {k: res[k] for k in ("t_compute", "t_memory", "t_collective")}
    res["bottleneck"] = max(terms, key=terms.get)
    return res


def fits(prod):
    ma = prod.get("memory_analysis", {})
    tot = (ma.get("argument_size_in_bytes", 0) or 0) + \
          (ma.get("temp_size_in_bytes", 0) or 0)
    return tot, tot <= HBM_PER_CHIP


def advice(res):
    b = res["bottleneck"]
    if b == "t_collective":
        return ("cut wire bytes further (int8→int4 quantized collectives) or "
                "overlap the gather with local compute")
    if b == "t_memory":
        return ("raise arithmetic intensity: fuse elementwise chains "
                "(quantize+EF kernel), larger attention blocks, better remat")
    return "increase per-chip work (larger per-agent batch) or cut redundant FLOPs"


def table(markdown=True):
    rows = []
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            res = extrapolate(arch, shape)
            if res is None:
                rows.append((arch, shape, None, "missing"))
                continue
            if "skipped" in res:
                rows.append((arch, shape, None, "skip (full attn @500k)"))
                continue
            prod = _load(f"{arch}__{shape}__single")
            mem, ok = fits(prod)
            multi = _load(f"{arch}__{shape}__multi")
            rows.append((arch, shape, res, dict(
                mem=mem, fits=ok,
                multi_ok=bool(multi) and "skipped" not in (multi or {}))))
    if not markdown:
        return rows
    lines = ["| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | bottleneck "
             "| useful FLOPs | mem/chip | multi-pod |",
             "|---|---|---|---|---|---|---|---|---|"]
    for arch, shape, res, extra in rows:
        if res is None:
            lines.append(f"| {arch} | {shape} | — | — | — | {extra} | — | — | — |")
            continue
        e = extra
        lines.append(
            f"| {arch} | {shape} | {res['t_compute']:.3e} | "
            f"{res['t_memory']:.3e} | {res['t_collective']:.3e} | "
            f"{res['bottleneck'][2:]} | "
            f"{res['useful_flops_ratio']:.2f} | "
            f"{e['mem']/1e9:.1f}GB{'✓' if e['fits'] else '⚠'} | "
            f"{'✓' if e['multi_ok'] else '✗'} |")
    return "\n".join(lines)


def main():
    import time
    t0 = time.time()
    rows = table(markdown=False)
    done = sum(1 for r in rows if r[2] is not None or "skip" in str(r[3]))
    print(table())
    us = (time.time() - t0) * 1e6
    print(f"roofline,{us:.0f},combos_done={done}/40")


if __name__ == "__main__":
    main()
