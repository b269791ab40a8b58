"""Wire codec benchmark: pack/unpack throughput + measured-vs-nominal bytes.

Counterpart of ``benchmarks/wire_bench.py``, two measurements:

  1. **Kernel throughput** — ``pack_bits``/``unpack_bits`` through
     :mod:`repro_torch.kernels.ops` (the CUDA kernels on the card, which
     take the place of the reference's "interpret" and "compiled" modes)
     across sizes and bit widths, reported as value-side MB/s, each
     round trip checked value for value;
  2. **Byte accounting** — measured ``WireMessage.nbytes`` per compressor
     vs the nominal ``wire_bits_per_scalar`` estimate: the ratio is the
     real header+padding overhead the simulator accounts for.

Run:  PYTHONPATH=src python -m repro_torch.bench.wire_bench [--tiny]
``--tiny``: smallest sizes, one repetition — fails fast on any pack/unpack
regression.  Runs on the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.compression import (Identity, RandD, ScaledSign, TopK,
                                UniformQuantizer)
from ..device import device_label, resolve_device
from ..kernels import ops, ref
from ..wire import measure_tree_bytes
from .timing import time_fn


def bench_kernels(sizes, bit_widths, reps, device=None) -> list:
    """MB/s of pack and unpack per (n, bits); returns the printed rows
    ``(route, n, bits, pack MB/s, unpack MB/s)``."""
    dev = resolve_device(device)
    route = "cuda" if dev.type == "cuda" else "plain"
    print(f"{'route':10s} {'n':>9s} {'bits':>4s} {'pack MB/s':>10s} "
          f"{'unpack MB/s':>12s}")
    rows = []
    for n in sizes:
        for bits in bit_widths:
            gen = torch.Generator().manual_seed(0)
            x = ref.to_uint32(torch.randint(0, 2 ** min(bits, 30), (n,),
                                            generator=gen).to(dev))
            words = ops.pack_bits(x, bits)
            t_pack = time_fn(lambda: ops.pack_bits(x, bits), reps=reps)
            t_unpack = time_fn(lambda: ops.unpack_bits(words, bits, n),
                               reps=reps)
            back = ops.unpack_bits(words, bits, n)
            if not torch.equal(ref.as_int64(back), ref.as_int64(x)):
                raise AssertionError(
                    f"round-trip broke: n={n} bits={bits} route={route}")
            mb = 4.0 * n / 1e6
            rows.append((route, n, bits, mb / t_pack, mb / t_unpack))
            print(f"{route:10s} {n:9d} {bits:4d} {mb / t_pack:10.1f} "
                  f"{mb / t_unpack:12.1f}")
    return rows


COMPRESSORS = {
    "identity": Identity(),
    "quant_fine": UniformQuantizer(levels=1000, vmin=-10, vmax=10,
                                   clip=True),
    "quant_coarse": UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True),
    "sign": ScaledSign(),
    "top_0.1": TopK(fraction=0.1),
    "rand_0.5": RandD(fraction=0.5),
}


def bench_accounting(n, x=None, device=None) -> list:
    """Nominal against measured bits per scalar for the six compressors
    on ``x`` (n values; a seeded normal draw unless given); returns the
    printed rows ``(name, nominal b/s, measured b/s, ratio)``."""
    dev = resolve_device(device)
    if x is None:
        x = np.random.default_rng(1).normal(size=n).astype(np.float32)
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(dev)
    print(f"\n{'compressor':14s} {'nominal b/s':>11s} {'measured b/s':>13s} "
          f"{'ratio':>7s}")
    rows = []
    for name, C in COMPRESSORS.items():
        y = C(torch.Generator(device=dev).manual_seed(2), x)
        measured = measure_tree_bytes(C, y)
        nominal_bs = C.wire_bits_per_scalar()
        measured_bs = 8.0 * measured / n
        rows.append((name, nominal_bs, measured_bs, measured_bs / nominal_bs))
        print(f"{name:14s} {nominal_bs:11.2f} {measured_bs:13.3f} "
              f"{measured_bs / nominal_bs:7.3f}")
    return rows


def main(tiny: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    t0 = time.time()
    if tiny:
        sizes, bit_widths, reps = [4096, 40000], [1, 4, 10], 1
    else:
        sizes, bit_widths, reps = [65536, 1 << 20, 1 << 22], [1, 4, 8, 16], 5
    label = device_label(dev)
    print(f"device: {label}")
    kernels = bench_kernels(sizes, bit_widths, reps, dev)
    accounting = bench_accounting(4096 if tiny else 1 << 20, device=dev)
    us = (time.time() - t0) * 1e6
    print(f"\nwire_bench,{us:.0f},route={kernels[0][0]}")
    return {"device": label, "kernels": kernels, "accounting": accounting}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tiny", action="store_true",
                   help="small sizes, 1 rep")
    main(tiny=p.parse_args().tiny)
