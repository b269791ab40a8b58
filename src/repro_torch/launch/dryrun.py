"""Dry-run: one production step on the full production mesh, shapes only.

Counterpart of ``repro.launch.dryrun``.  The JAX package lowers and
compiles its step for 256 (512) forced host devices and reads XLA's cost
and memory analyses.  The port runs the same step on the **meta device**:
parameters, state, batch and cache are DTensors whose local shards are
meta tensors, laid out by :mod:`.sharding`'s rules over the production
``DeviceMesh``, which spans a fake process group of 256 (512) ranks made
inside :func:`run_dryrun` and destroyed there (``torch.testing._internal.
distributed.fake_pg``: collectives return at once and move nothing).  As
rank 0 the process dispatches its own share of the step, and a dispatch
mode counts it, per device:

* ``hlo_flops_per_chip``: the FLOPs of the local ops, by
  ``torch.utils.flop_counter``'s formulas (products; replicated work
  counts on every device, as in XLA's per-partition module), plus each
  hand-written kernel's work as ``PERF.md`` §3 layer 6 counts it for its
  bound (attention: 4·B·H·pairs·D forward, 10·B·H·pairs·D backward);
* ``hlo_bytes_per_chip``: bytes the local ops read and write (views move
  none; a kernel reads each input and writes each output once);
* ``collective_bytes`` / ``collective_counts``: output bytes of each
  functional collective, under XLA's names;
* ``memory_analysis``: the arguments' local bytes, the peak of the live
  bytes the step allocates (``temp_size_in_bytes``), its outputs' local
  bytes; ``None`` where torch has no counterpart.

The record's keys are the JAX package's, so :mod:`repro_torch.bench.
roofline` reads it unchanged; ``lower_s`` is the time to build the
inputs, ``compile_s`` the time to run the step.  The roofline constants
are the H100's.  Usage::

    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS
from ..core.deploy import DeployFedLT, DeployState
from ..core.pytree import tree_map
from ..kernels import _build
from ..models.transformer import init_cache, init_params
from .mesh import agent_axes, destroy_process_group, make_production_mesh, n_agents
from .serve import make_decode_step, make_prefill_step
from .sharding import (P, batch_specs, cache_specs, local_shape, param_specs,
                       placements)

SHAPES = {
    "train_4k":    dict(seq=4096,   batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,  batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,  batch=128, kind="decode"),
    "long_500k":   dict(seq=524288, batch=1,   kind="decode"),
}

# agent placement per arch: big models = one agent per pod
AGENT_AXIS = {
    "musicgen-large": "data", "qwen2-vl-7b": "data", "stablelm-1.6b": "data",
    "zamba2-2.7b": "data", "h2o-danube-3-4b": "data", "rwkv6-3b": "data",
    "granite-20b": "pod", "mixtral-8x7b": "pod", "gemma3-27b": "pod",
    "grok-1-314b": "pod",
}

# H100 roofline constants, for the card that `nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader` names "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s per GPU (SXM5)
HBM_BW = 3.35e12           # HBM3 bytes/s per GPU
NVLINK_BW = 450e9          # NVLink 4 bytes/s per direction per GPU; a
                           # 256-GPU mesh spans 32 nodes of 8, so the
                           # collective time at this rate is a lower bound

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional collectives (torch.ops._c10d_functional) by XLA's name
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all", "broadcast": "collective-permute"}
_MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "alias_size_in_bytes",
                  "generated_code_size_in_bytes")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for aligned positions 0…S−1, as
    every dry-run shape has them: causal, and within ``window`` if > 0."""
    if not causal:
        return sq * sk
    off = sk - sq                       # keys ahead of the first query
    rows = torch.arange(sq, dtype=torch.int64) + off + 1
    rows = rows.clamp(max=sk)
    if window:
        rows = rows.clamp(max=window)
    return int(rows.sum())


# the ints of each attention kernel's C signature (kernels/_build.py):
# index of (B, H, Hkv, Sq, Sk, D) and of (causal, window)
_ATTN_ARGS = {"flash_attention": (15, 21), "flash_attention_sm90": (15, 22),
              "flash_attention_bwd": (13, 20), "flash_attention_bwd_sm90": (25, 33)}


def kernel_work(name: str, args) -> tuple:
    """(FLOPs, bytes) of one kernel call on meta tensors, as ``PERF.md`` §3
    layer 6 counts its bound: each tensor read or written once; attention
    4·B·H·pairs·D (forward) or 10·B·H·pairs·D (backward: five products),
    the uplink kernels a few operations per value."""
    nbytes = sum(_nbytes(a) for a in args if isinstance(a, torch.Tensor))
    if name in _ATTN_ARGS:
        i, j = _ATTN_ARGS[name]
        b, h, _hkv, sq, sk, d = args[i:i + 6]
        pairs = _visible_pairs(sq, sk, bool(args[j]), args[j + 1])
        per = 10 if name.startswith("flash_attention_bwd") else 4
        return per * b * h * pairs * d, nbytes
    n = max((a.numel() for a in args if isinstance(a, torch.Tensor)), default=0)
    return 8 * n, nbytes


class PerDeviceCounter(TorchDispatchMode):
    """Counts one device's share of a step dispatched on DTensors: the mode
    lets DTensor (and the functional collectives' async tensors) unwrap
    first, so it sees the ops on local shards, and skips the global-shape
    runs of DTensor's sharding propagation (fake tensors)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = {c: 0 for c in _COLLECTIVES}
        self.coll_counts = {c: 0 for c in _COLLECTIVES}
        self.live = {}          # storage key → (weak ref, bytes)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._ops = 0

    def __enter__(self):
        self._hook, _build.meta_hook = _build.meta_hook, self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        _build.meta_hook = self._hook
        return super().__exit__(*exc)

    def _kernel(self, name, args):
        flops, nbytes = kernel_work(name, args)
        self.flops += flops
        self.bytes += nbytes

    def _track(self, t):
        from torch.multiprocessing.reductions import StorageWeakRef
        ref = StorageWeakRef(t.untyped_storage())
        if ref.cdata not in self.live:
            n = t.untyped_storage().nbytes()
            self.live[ref.cdata] = (ref, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _sweep(self):
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed._functional_collectives import AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor)) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                  # DTensor's global-shape propagation
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _FUNCOL.get(func._opname)
            if kind is not None:
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += sum(_nbytes(t) for t in outs)
            for t in outs:
                self._track(t)
            return out
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view and func._opname not in ("empty", "empty_strided",
                                                      "empty_like", "detach"):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            if not func.is_view:
                self._track(t)
        self._ops += 1
        if self._ops % 64 == 0:
            self._sweep()
        return out


# ---------------------------------------------------------------------------
# inputs as meta stand-ins and DTensors over meta shards
# ---------------------------------------------------------------------------

def _sds(shape, dtype):
    """A shape-and-dtype stand-in (JAX's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _tokens_sds(a, b, s):
    lead = (a,) if a else ()
    return {"tokens": _sds(lead + (b, s), torch.int32),
            "labels": _sds(lead + (b, s), torch.int32)}


def input_specs(arch: str, shape: str, a: int = 0):
    """Meta stand-ins for every model input (no allocation)."""
    cfg = ARCHS[arch]
    info = SHAPES[shape]
    s, b = info["seq"], info["batch"]
    dtype = getattr(torch, cfg.dtype)
    if info["kind"] == "train":
        b_per = b // max(a, 1)
        if cfg.arch_type == "vlm":
            s_vis = s // 4
            s_txt = s - s_vis
            lead = (a,) if a else ()
            return {
                "tokens": _sds(lead + (b_per, s_txt), torch.int32),
                "extra_embeds": _sds(lead + (b_per, s_vis, cfg.d_model), dtype),
                "labels": _sds(lead + (b_per, s), torch.int32),
                "positions": _sds(lead + (3, b_per, s), torch.int32),
            }
        return _tokens_sds(a, b_per, s)
    if info["kind"] == "prefill":
        if cfg.arch_type == "vlm":
            s_vis = s // 4
            return {
                "tokens": _sds((b, s - s_vis), torch.int32),
                "extra_embeds": _sds((b, s_vis, cfg.d_model), dtype),
                "positions": _sds((3, b, s), torch.int32),
            }
        return {"tokens": _sds((b, s), torch.int32)}
    # decode: one new token against an s-long cache
    return {"tokens": _sds((b, 1), torch.int32)}


def _on_mesh(sds, mesh, spec):
    """A DTensor of ``sds``'s global shape whose local shard is a meta
    tensor laid out by ``spec``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(_sds(local_shape(sds.shape, mesh, spec), sds.dtype), mesh,
                              placements(spec, mesh), run_check=False, shape=sds.shape,
                              stride=sds.stride())


def _placed(tree, mesh, specs):
    return tree_map(lambda x, s: _on_mesh(x, mesh, s) if isinstance(x, torch.Tensor)
                    else x, tree, specs)


def model_flops(cfg, shape_name: str, n_epochs: int, a: int) -> float:
    info = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = info["batch"] * info["seq"]
    if info["kind"] == "train":
        return 6.0 * n_active * tokens * n_epochs
    if info["kind"] == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * info["batch"]  # decode: one token per sequence


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return ARCHS[arch].subquadratic
    return True


def _fake_process_group(world_size: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def run_dryrun(arch: str, shape: str, multi_pod: bool, *, n_epochs: int = 2,
               compress: bool = True, moe_dispatch: Optional[str] = None,
               backend: str = "chunked", donate: bool = True,
               unroll: bool = False, scan_repeats_override: Optional[int] = None,
               kv_int8: bool = False, remat_group: int = 1):
    """One step of ``arch`` at ``shape`` on the production mesh, counted per
    device (module docstring).  ``unroll`` sets ``cfg.scan_unroll``:
    attention takes the JAX package's unrolled chunk pairs, plain ops,
    instead of the kernel (counted by its formula).
    ``scan_repeats_override=R`` builds a reduced-depth variant (R units +
    tail); the roofline extrapolates R=1 and R=2 linearly to the real depth.
    ``donate`` has no counterpart: the step allocates its outputs anew.
    A fake process group of the mesh's size is made here, unless one is
    up, and destroyed on return."""
    import torch.distributed as dist

    del donate
    cfg = ARCHS[arch]
    cfg = dataclasses.replace(cfg, scan_unroll=unroll)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    if remat_group > 1:
        cfg = dataclasses.replace(cfg, remat_group=remat_group)
    if scan_repeats_override is not None:
        n_layers = len(cfg.scan_unit) * scan_repeats_override + len(cfg.tail)
        cfg = dataclasses.replace(cfg, scan_repeats=scan_repeats_override,
                                  n_layers=n_layers)
    if moe_dispatch and cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    n_chips = 512 if multi_pod else 256
    own_group = not dist.is_initialized()
    if own_group:
        _fake_process_group(n_chips)
    try:
        return _run(cfg, arch, shape, multi_pod, n_chips, n_epochs, compress, backend)
    finally:
        if own_group:
            destroy_process_group()


def _run(cfg, arch, shape, multi_pod, n_chips, n_epochs, compress, backend):
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    info = SHAPES[shape]
    ax = AGENT_AXIS[arch]
    if ax == "pod" and cfg.n_experts and info["kind"] == "train":
        # per-agent batch is data-sharded → keep MoE dispatch tokens sharded
        cfg = dataclasses.replace(cfg, act_batch_axis="data")
    aaxes = agent_axes(mesh, ax)
    a = n_agents(mesh, ax)

    t0 = time.time()
    p0 = init_params(cfg, device="meta")
    if info["kind"] == "train":
        alg = DeployFedLT(cfg=cfg, n_epochs=n_epochs, compress=compress,
                          backend=backend)
        xa = tree_map(lambda t: _sds((a,) + tuple(t.shape), t.dtype), p0)
        # agents on the data axis ⇒ per-agent weights are TP-only;
        # agents on the pod axis ⇒ weights are FSDP(data) × TP(model)
        fsdp = None if ax == "data" else "data"
        ps_agent = param_specs(xa, mesh, agent_axes=aaxes, stacked=True, fsdp=fsdp)
        ps_coord = param_specs(p0, mesh, agent_axes=())
        state = DeployState(x=_placed(xa, mesh, ps_agent), z=_placed(xa, mesh, ps_agent),
                            c_up=_placed(xa, mesh, ps_agent),
                            y_hat=_placed(p0, mesh, ps_coord),
                            c_down=_placed(p0, mesh, ps_coord), k=0)
        batch_sds = input_specs(arch, shape, a)
        batch = _placed(batch_sds, mesh, batch_specs(batch_sds, mesh, agent_axes=aaxes,
                                                     stacked=True))
        # wire gather target: replicate the agent dim, keep weight dims
        rep_spec = tree_map(lambda _, s: P(None, *tuple(s)[1:]), xa, ps_agent)
        args = (state, batch)

        def step():
            return alg.round_step(state, batch, agent_replicate_spec=rep_spec)
    else:
        params = _placed(p0, mesh, param_specs(p0, mesh, agent_axes=()))
        batch_sds = input_specs(arch, shape)
        if info["kind"] == "prefill":
            prefill = make_prefill_step(cfg, backend=backend)
            batch = _placed(batch_sds, mesh, batch_specs(batch_sds, mesh, agent_axes=()))
            args = (params, batch)

            def step():
                return prefill(params, batch)
        else:
            b = info["batch"]
            cache_sds = init_cache(cfg, b, s_max=info["seq"],
                                   dtype=getattr(torch, cfg.dtype), device="meta")
            cache = _placed(cache_sds, mesh, cache_specs(cache_sds, mesh,
                                                         shard_batch=(b > 1)))
            tok = _placed(batch_sds, mesh, batch_specs(batch_sds, mesh, agent_axes=()))
            decode = make_decode_step(cfg, backend=backend)
            args = (params, cache, tok)

            def step():
                return decode(params, cache, tok["tokens"])
    t_lower = time.time() - t0

    t0 = time.time()
    counter = PerDeviceCounter()
    with counter:
        out = step()
    t_compile = time.time() - t0

    local = lambda t: t.to_local() if hasattr(t, "to_local") else t
    arg_bytes = sum(_nbytes(local(t)) for t in _tensors(args))
    out_bytes = sum(_nbytes(local(t)) for t in _tensors(out))
    mem_d = dict.fromkeys(_MEMORY_FIELDS)
    mem_d.update(argument_size_in_bytes=arg_bytes, output_size_in_bytes=out_bytes,
                 temp_size_in_bytes=counter.peak_bytes)

    flops = float(counter.flops)
    bytes_acc = float(counter.bytes)
    coll_total = float(sum(counter.coll_bytes.values()))
    mf = model_flops(cfg, shape, n_epochs, a)
    result = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "agent_axis": ax, "n_agents": a, "n_chips": n_chips,
        "hlo_flops_per_chip": flops, "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes": dict(counter.coll_bytes),
        "collective_counts": dict(counter.coll_counts),
        "collective_bytes_total": coll_total,
        "memory_analysis": mem_d,
        "model_flops": mf,
        "useful_flops_ratio": mf / (flops * n_chips) if flops else None,
        # roofline terms (seconds), per-device basis
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bytes_acc / HBM_BW,
        "t_collective": coll_total / NVLINK_BW,
        "lower_s": t_lower, "compile_s": t_compile,
    }
    terms = {k: result[k] for k in ("t_compute", "t_memory", "t_collective")}
    result["bottleneck"] = max(terms, key=terms.get)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--n-epochs", type=int, default=2)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=(None, "dense", "capacity"))
    ap.add_argument("--backend", default="chunked")
    ap.add_argument("--unroll", action="store_true")
    ap.add_argument("--scan-repeats", type=int, default=None)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--remat-group", type=int, default=1)
    args = ap.parse_args(argv)

    if not applicable(args.arch, args.shape):
        js = json.dumps({"arch": args.arch, "shape": args.shape,
                         "skipped": "full-attention arch at 500k ctx"})
        print(js)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(js)
        return

    res = run_dryrun(args.arch, args.shape, args.mesh == "multi",
                     n_epochs=args.n_epochs, compress=not args.no_compress,
                     moe_dispatch=args.moe_dispatch, backend=args.backend,
                     unroll=args.unroll,
                     scan_repeats_override=args.scan_repeats,
                     kv_int8=args.kv_int8, remat_group=args.remat_group)
    js = json.dumps(res, indent=2, default=str)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
