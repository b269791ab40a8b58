"""The port's dry-run: one production step on the meta device, counted per
device over a fake 256- (512-) rank process group.

One subprocess runs ``python -m repro_torch.launch.dryrun``'s ``main`` for
stablelm-1.6b at ``decode_32k`` on both production meshes and at
``train_4k`` (unrolled, one scan repeat), and granite-20b at
``long_500k``, which the JAX package skips (a full-attention arch at a
500k context).  The records keep the JAX package's keys; the per-device
argument bytes equal the sum of the local shard bytes that the JAX
package's own spec functions give for the same inputs (its
``param_specs``/``batch_specs``/``cache_specs`` on an ``AbstractMesh``),
the scalar leaves aside (the JAX package's round counter and cache length
are int32 arrays, the port's Python ints).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
RUNS = {"decode_single": ["--arch", "stablelm-1.6b", "--shape", "decode_32k"],
        "decode_multi": ["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                         "--mesh", "multi"],
        "train": ["--arch", "stablelm-1.6b", "--shape", "train_4k", "--unroll",
                  "--scan-repeats", "1"],
        "skip": ["--arch", "granite-20b", "--shape", "long_500k"]}
KEYS = {"arch", "shape", "mesh", "agent_axis", "n_agents", "n_chips",
        "hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes",
        "collective_counts", "collective_bytes_total", "memory_analysis",
        "model_flops", "useful_flops_ratio", "t_compute", "t_memory",
        "t_collective", "lower_s", "compile_s", "bottleneck"}
COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"for name, argv in {RUNS!r}.items():\n"
            f"    dryrun.main(argv + ['--out', {str(out)!r} + '/' + name + '.json'])\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {name: json.loads((out / f"{name}.json").read_text()) for name in RUNS}


@pytest.mark.parametrize("name", ["decode_single", "decode_multi", "train"])
def test_record_keys_and_counts(records, name):
    r = records[name]
    assert set(r) == KEYS
    assert set(r["collective_bytes"]) == set(r["collective_counts"]) == COLLECTIVES
    assert r["n_chips"] == (512 if name == "decode_multi" else 256)
    assert r["mesh"] == ("2x16x16" if name == "decode_multi" else "16x16")
    assert r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0
    assert r["collective_bytes_total"] == sum(r["collective_bytes"].values()) > 0
    assert r["bottleneck"] in ("t_compute", "t_memory", "t_collective")
    assert r["t_compute"] == pytest.approx(r["hlo_flops_per_chip"] / 989e12)
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] is None


def test_train_record_has_agents_and_collectives(records):
    r = records["train"]
    assert r["n_agents"] == 16 and r["agent_axis"] == "data"
    assert r["collective_bytes_total"] > 0 and r["collective_counts"]["all-gather"] > 0


def test_multi_pod_shrinks_the_per_device_decode(records):
    """Twice the devices over the same batch: the cache's batch spreads over
    pods too, so each device holds less."""
    single = records["decode_single"]["memory_analysis"]["argument_size_in_bytes"]
    multi = records["decode_multi"]["memory_analysis"]["argument_size_in_bytes"]
    assert records["decode_multi"]["n_agents"] == 32
    assert multi < single


def test_full_attention_arch_at_500k_is_skipped(records):
    r = records["skip"]
    assert r["arch"] == "granite-20b" and r["shape"] == "long_500k"
    assert "skipped" in r and "hlo_flops_per_chip" not in r


def _local_bytes(tree, specs, mesh):
    """Σ of each device's shard bytes under the JAX package's specs (sizes
    from the mesh's axes), less its int32 counters: 0-d leaves and the
    caches' ``length`` (a Python int in the port)."""
    import jax
    from jax.sharding import PartitionSpec as JP

    total = 0
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    for (path, leaf), spec in zip(leaves, spec_leaves):
        if not leaf.shape or jax.tree_util.keystr(path).endswith("length"):
            continue
        div = 1
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    div *= mesh.shape[ax]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // div
    return total


def test_argument_bytes_equal_the_jax_specs_shards(records):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.configs import ARCHS
    from repro.launch import sharding as js
    from repro.models.transformer import init_cache, init_params

    # the JAX package's dry-run inputs (repro.launch.dryrun.input_specs, not
    # imported: that module forces 512 host devices on import)
    def tokens(*shape, labels=False):
        sds = jax.ShapeDtypeStruct(shape, jnp.int32)
        return {"tokens": sds, "labels": sds} if labels else {"tokens": sds}

    # decode_32k on both meshes: params, the 32k cache, one token per row
    cfg = ARCHS["stablelm-1.6b"]
    params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    cache = jax.eval_shape(lambda: init_cache(cfg, 128, 32768, jnp.dtype(cfg.dtype)))
    for name, mesh in (("decode_single", AbstractMesh((16, 16), ("data", "model"))),
                       ("decode_multi", AbstractMesh((2, 16, 16),
                                                     ("pod", "data", "model")))):
        tok = tokens(128, 1)
        want = (_local_bytes(params, js.param_specs(params, mesh), mesh)
                + _local_bytes(cache, js.cache_specs(cache, mesh, shard_batch=True), mesh)
                + _local_bytes(tok, js.batch_specs(tok, mesh), mesh))
        assert records[name]["memory_analysis"]["argument_size_in_bytes"] == want, name

    # train_4k at one scan repeat: the agent-stacked state and the batch
    cfg1 = dataclasses.replace(cfg, scan_repeats=1,
                               n_layers=len(cfg.scan_unit) + len(cfg.tail))
    mesh = AbstractMesh((16, 16), ("data", "model"))
    p0 = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg1))
    xa = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct((16,) + s.shape, s.dtype),
                                p0)
    ps_agent = js.param_specs(xa, mesh, agent_axes=("data",), stacked=True, fsdp=None)
    ps_coord = js.param_specs(p0, mesh, agent_axes=())
    batch = tokens(16, 256 // 16, 4096, labels=True)
    want = (3 * _local_bytes(xa, ps_agent, mesh) + 2 * _local_bytes(p0, ps_coord, mesh)
            + _local_bytes(batch, js.batch_specs(batch, mesh, agent_axes=("data",),
                                                 stacked=True), mesh))
    assert records["train"]["memory_analysis"]["argument_size_in_bytes"] == want


def test_dryrun_module_makes_no_process_group_at_import():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun as d\n"
            "assert not dist.is_initialized()\n"
            "assert d.PEAK_FLOPS == 989e12 and d.HBM_BW == 3.35e12\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_roofline_extrapolates_as_the_reference(tmp_path, monkeypatch):
    """``bench.roofline`` over R=1/R=2 records: the same extrapolated totals
    and fits-check arithmetic as the JAX package's ``benchmarks/roofline.py``
    on the same records, its terms at the H100's rates."""
    from benchmarks import roofline as jroof
    from repro_torch.bench import roofline as troof

    base = {"arch": "stablelm-1.6b", "shape": "train_4k", "mesh": "16x16",
            "n_chips": 256, "model_flops": 1e18, "bottleneck": "t_memory",
            "memory_analysis": {"argument_size_in_bytes": 10, "temp_size_in_bytes": 5}}
    recs = {"": dict(base, hlo_flops_per_chip=9.0, hlo_bytes_per_chip=9.0,
                     collective_bytes_total=9.0),
            "__unroll1": dict(base, hlo_flops_per_chip=3e12, hlo_bytes_per_chip=2e11,
                              collective_bytes_total=1e9),
            "__unroll2": dict(base, hlo_flops_per_chip=5e12, hlo_bytes_per_chip=3e11,
                              collective_bytes_total=1.5e9)}
    for tag, rec in recs.items():
        (tmp_path / f"stablelm-1.6b__train_4k__single{tag}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(troof, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(jroof, "OUT_DIR", str(tmp_path))
    ours = troof.extrapolate("stablelm-1.6b", "train_4k")
    theirs = jroof.extrapolate("stablelm-1.6b", "train_4k")
    for key in ("hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes_total",
                "useful_flops_ratio", "extrapolated"):
        assert ours[key] == theirs[key], key
    assert ours["hlo_flops_per_chip"] == 3e12 + 23 * 2e12          # 24 repeats
    assert ours["t_compute"] == ours["hlo_flops_per_chip"] / 989e12
    assert troof.fits(ours) == (15, True)
    assert "stablelm-1.6b | train_4k" in troof.table()


def test_kernel_wrappers_are_shape_only_on_meta(monkeypatch):
    """On meta tensors every kernel wrapper allocates its outputs (shapes,
    dtypes, the attention's statistics through autograd) and launches
    nothing: no launch is counted, no plain version runs, and the dry-run's
    hook sees each kernel by name."""
    import torch

    from repro_torch.kernels import _build, ops, ref

    for name in ("quant_pipeline_ref", "pack_bits_ref", "unpack_bits_ref",
                 "quantize_ef_ref", "sign_pipeline_ref", "erasure_mask_ref",
                 "flash_attention_ref", "flash_attention_bwd_ref"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail("a plain version ran"))
    seen = []
    monkeypatch.setattr(_build, "meta_hook", lambda name, args: seen.append(name))
    ops.reset_launch_counts()
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    words, cache = ops.quant_pipeline(meta(4, 40000), meta(4, 40000))
    assert words.is_meta and words.dtype == torch.uint32 and cache.shape == (4, 40000)
    assert ops.unpack_bits(words, 8, 160000).shape == (160000,)
    assert ops.pack_bits(meta(1000, dtype=torch.int32), 4).is_meta
    assert all(t.is_meta for t in ops.quantize_ef(meta(2048), meta(2048)))
    assert ops.sign_pipeline(meta(2048), meta(2048))[2].shape == (2048,)
    assert ops.erasure_mask(meta(8192, dtype=torch.uint32), p=0.1)[0].shape == (8192,)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (meta(2, 256, 4, 64, dtype=dtype).requires_grad_() for _ in range(3))
        out = ops.attention(q, k, v)
        grads = torch.autograd.grad(out.sum(), (q, k, v))
        assert out.is_meta and out.dtype == dtype
        assert all(g.is_meta and g.shape == q.shape for g in grads)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert seen == ["quant_pipeline", "unpack_bits", "pack_bits", "quantize_ef",
                    "sign_pipeline", "erasure_mask", "flash_attention_sm90",
                    "flash_attention_bwd_sm90", "flash_attention", "flash_attention_bwd"]
