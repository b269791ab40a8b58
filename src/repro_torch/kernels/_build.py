"""Build, load and launch the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by its own ``nvcc`` into a shared
library with a plain C interface, all of them at once, on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/<stem>-<hash>.so <stem>.cu

The libraries land in ``build/repro_torch_kernels/`` at the repository
root, keyed by a hash of every file in ``csrc/`` and the flags, and are
loaded with ``ctypes``.  Every C entry point takes raw device pointers,
``int`` sizes and the current stream, and returns ``cudaGetLastError()``
after its launch; :func:`launch` raises when that is not 0 and counts the
launch only when it succeeded.

Nothing is built when this module is imported: the CPU tests import it on
machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("pack_bits.cu", "quant_pipeline.cu", "quantize_ef.cu", "erasure_mask.cu",
           "sign_pipeline.cu", "flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
#: kernel name -> (source, C entry point, argument types without the stream)
KERNELS = {
    # vals, words, n, bits, tiles
    "pack_bits": ("pack_bits.cu", "repro_pack_bits", (_P, _P, _I, _I, _I)),
    # words, vals, n, bits, tiles
    "unpack_bits": ("pack_bits.cu", "repro_unpack_bits", (_P, _P, _I, _I, _I)),
    # msg, cache, words, new_cache, n, bits, tiles, levels, vmin, vmax,
    # delta, 1/delta, bf16 (msg and cache bf16, else float32)
    "quant_pipeline": ("quant_pipeline.cu", "repro_quant_pipeline",
                       (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I)),
    # msg, cache, wire, new_cache, n, levels, vmin, vmax, delta, 1/delta
    "quantize_ef": ("quantize_ef.cu", "repro_quantize_ef",
                    (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F)),
    # words, masked, keep, n, segment_words, seed_lo, seed_hi, threshold
    "erasure_mask": ("erasure_mask.cu", "repro_erasure_mask",
                     (_P, _P, _P, _I, _U, _U, _U, _U)),
    # msg, cache, words, new_cache, scale (out), partials (float64 scratch),
    # n, tiles, bf16 (msg and cache bf16, else float32); one cooperative launch
    "sign_pipeline": ("sign_pipeline.cu", "repro_sign_pipeline",
                      (_P, _P, _P, _P, _P, _P, _I, _I, _I)),
    # q, k, v, out, q_pos, k_pos, the (B, S, H) strides of q, k and v,
    # B, H, Hkv, Sq, Sk, D, causal, window, scale, softcap, vec (16-byte
    # copies), and the backward's statistics lse (null for none) and its row
    "flash_attention": ("flash_attention.cu", "repro_flash_attention",
                        (_P,) * 6 + (_L,) * 9 + (_I,) * 8 + (_F, _F, _I, _P, _I)),
    # q, k, v, out, q_pos, k_pos, the (B, S, H) strides of q, k and v,
    # B, H, Hkv, Sq, Sk, D, padded D, causal, window, scale, softcap, and
    # the backward's statistics lse and o32 (null for none) and lse's row
    "flash_attention_sm90": ("flash_attention_sm90.cu", "repro_flash_attention_sm90",
                             (_P,) * 6 + (_L,) * 9 + (_I,) * 9 + (_F, _F, _P, _P, _I)),
    # q, k, v, dout, dq, dk, dv, lse and o (the forward's), delta and nokey
    # (scratch), q_pos, k_pos, B, H, Hkv, Sq, Sk, D, lse's row, causal,
    # window, scale, softcap (float32 only); one call enqueues its three
    # grids and counts as one
    "flash_attention_bwd": ("flash_attention_bwd.cu", "repro_flash_attention_bwd",
                            (_P,) * 13 + (_I,) * 9 + (_F, _F)),
    # q, k, v, dout, dq, dk, dv, lse and o32 (the forward's), delta and
    # nokey (scratch), q_pos, k_pos, the (B, S, H) strides of q, k, v and
    # dout, B, H, Hkv, Sq, Sk, D, padded D, lse's row, causal, window,
    # scale, softcap; one call enqueues its three grids and counts as one
    "flash_attention_bwd_sm90": ("flash_attention_bwd_sm90.cu",
                                 "repro_flash_attention_bwd_sm90",
                                 (_P,) * 13 + (_L,) * 12 + (_I,) * 10 + (_F, _F)),
}

#: launches per kernel, counted where :func:`launch` starts the kernel and
#: nowhere else (a plain integer each; reset with :func:`reset_launches`)
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source not yet built (one ``nvcc`` each, in parallel)
    and return ``{source: library path}``.  Compiler output (``-Xptxas=-v``
    register and spill counts) is kept in :data:`build_log`."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src: BUILD_DIR / f"{Path(src).stem}-{digest}.so" for src in SOURCES}
    jobs = []
    for src, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, proc, tmp, out))
    failed = []
    for src, proc, tmp, out in jobs:
        build_log[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{build_log[src]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _library(src: str) -> ctypes.CDLL:
    if src not in _libs:
        lib = ctypes.CDLL(str(build()[src]))
        for k_src, symbol, argtypes in KERNELS.values():
            if k_src == src:
                fn = getattr(lib, symbol)
                fn.argtypes = [*argtypes, _P]
                fn.restype = _I
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[src] = lib
    return _libs[src]


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream; tensors are passed as
    device pointers.  Raises when the launch reports a CUDA error."""
    src, symbol, _ = KERNELS[name]
    lib = _library(src)
    fn = getattr(lib, symbol)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args), stream)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    launches[name] += 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
