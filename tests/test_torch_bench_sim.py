"""The port's engine benchmarks, phase profile, ``sync_device`` split and
wire accounting against the JAX package's.

Counts, not times: ``bench_scale``'s active satellites and async
deliveries, ``bench_fast_round``'s deliveries, the engines' trajectories
under ``bench_round_pipeline``/``bench_lossy_round``, the phase paths and
counts of ``profile_phases``, the kernel records a traced dispatch leaves
with and without ``prof_sync``, and ``bench_accounting``'s measured bits
per scalar must equal the reference's on the same arguments (the same
numpy input for the accounting).  The kernel benches run their plain
versions here.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.sim import Engine as JEngine
from repro.wire import measure_tree_bytes as j_measure_tree_bytes
from repro_torch import obs
from repro_torch.bench import common, kernel_bench, profile_round
from repro_torch.bench import sim_scale, wire_bench
from repro_torch.kernels import ops
from repro_torch.sim import Engine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import common as bcommon
    from benchmarks import profile_round as bprofile
    from benchmarks import sim_scale as bss
    return bss, bcommon, bprofile


def test_bench_scale_counts_equal_reference(ref):
    bss = ref[0]
    got = sim_scale.bench_scale(100, rounds=3, async_deliveries=100)
    want = bss.bench_scale(100, rounds=3, async_deliveries=100)
    assert sorted(got) == sorted(want)
    for k in ("n_sats", "sync_active", "async_n"):
        assert got[k] == want[k], k
    assert got["sync_active"] > 0 and got["async_n"] == 100


def test_scenario_equals_reference(ref):
    for n in (20, 64, 100, 1000):
        assert repr(sim_scale._scenario(n)) == repr(ref[0]._scenario(n))


def test_bench_fast_round_deliveries_equal_reference(ref):
    bss = ref[0]
    got = sim_scale.bench_fast_round(100, rounds=2, async_deliveries=50)
    want = bss.bench_fast_round(100, rounds=2, async_deliveries=50)
    assert sorted(got) == sorted(want)
    for k in ("n_sats", "rounds", "deliveries"):
        assert got[k] == want[k], k
    assert got["async_speedup"] > 0 and got["sync_speedup"] > 0


@pytest.mark.parametrize("package", ["port", "reference"])
def test_fast_oracle_equivalence_raises_on_engines_that_differ(ref, package):
    check = (common.assert_fast_oracle_equivalent if package == "port"
             else ref[1].assert_fast_oracle_equivalent)
    make = Engine if package == "port" else JEngine
    sc = sim_scale._scenario if package == "port" else ref[0]._scenario
    msg = sim_scale.MSG
    res = check(make(sc(20), fast=True), make(sc(20), fast=False), msg,
                rounds=2, async_deliveries=20)
    assert len(res) == 2
    with pytest.raises(AssertionError, match="diverged"):
        check(make(sc(20), fast=True), make(sc(30), fast=False), msg,
              rounds=2, async_deliveries=20)


def test_round_pipeline_wrappers_keep_reference_keys(ref):
    bss = ref[0]
    n, rounds = 20, 2
    r = sim_scale.bench_round_pipeline(n, rounds=rounds, device="cpu")
    assert sorted(r) == sorted([
        "n_sats", "rounds", "deliveries", "engine_s_per_round",
        "round_s_unfused", "round_s_fused", "speedup", "sats_per_sec_fused"])
    eng = JEngine(bss._scenario(n), seed=0)
    t, want = 0.0, 0
    for _ in range(rounds):
        res = eng.run_round(t, bss.MSG)
        t += res.duration
        want += len(res.deliveries)
    assert r["deliveries"] == want > 0
    assert r["round_s_unfused"] > r["engine_s_per_round"] > 0
    assert r["speedup"] == r["round_s_unfused"] / r["round_s_fused"]
    lossy = sim_scale.bench_lossy_round(n, rounds=rounds, device="cpu")
    assert sorted(lossy) == sorted([
        "n_sats", "rounds", "attempted", "lost", "retransmissions",
        "round_s_lossless", "round_s_lossy", "channel_overhead",
        "uplink_s_unfused", "uplink_s_fused", "lossy_uplink_speedup"])
    assert lossy["attempted"] > 0 and lossy["n_sats"] == n


def _phase_counts(profile):
    return {p: e["count"] for p, e in profile["phases"].items()}


@pytest.mark.parametrize("fast", [True, False])
def test_profile_phases_paths_and_counts_equal_reference(ref, fast):
    bprofile = ref[2]
    got = profile_round.profile_phases("walker-kiruna", 2, 0, fast=fast)
    want = bprofile.profile_phases("walker-kiruna", 2, 0, fast=fast)
    assert _phase_counts(got) == _phase_counts(want)
    assert got["units"] == want["units"] == 2
    assert got["engines"] == want["engines"] and got["modes"] == want["modes"]
    assert "walker-kiruna" in obs.render_profile(got, title="walker-kiruna")


def test_profile_round_main_checks_equivalence(tmp_path, capsys):
    out, flame = tmp_path / "p.txt", tmp_path / "p.folded"
    assert profile_round.main(["--scenario", "walker-kiruna", "--rounds", "2",
                               "--check-equivalence", "--out", str(out),
                               "--flame", str(flame)]) == 0
    text = capsys.readouterr().out
    assert "equivalence OK" in text and "attributed" in text
    assert out.read_text().startswith("# profile_round --scenario "
                                      "walker-kiruna --rounds 2")
    assert flame.read_text()


def _kernel_records(records):
    return [r["name"] for r in records if r["kind"] == "kernel"]


@pytest.mark.parametrize("prof_sync", [True, False])
def test_prof_sync_split_equals_reference(prof_sync):
    x = np.arange(100, dtype=np.uint32) % 16
    meta = {"prof_sync": True} if prof_sync else {}
    with obs.tracing(None, **meta) as trc:
        ops.pack_bits(torch.from_numpy(x.astype(np.int64)), 4)
        got = _kernel_records(trc.records())
        got_phases = {p: e[0] for p, e in trc.prof._acc.items()}
    with jobs.tracing(None, **meta) as jtrc:
        jops.pack_bits(jnp.asarray(x), 4)
        want = _kernel_records(jtrc.records())
        want_phases = {p: e[0] for p, e in jtrc.prof._acc.items()}
    assert got == want
    assert got_phases == want_phases
    assert trc.prof.sync_device is prof_sync
    expect = ["pack_bits", "pack_bits[device]"] if prof_sync else ["pack_bits"]
    assert got == expect


def test_bench_accounting_equals_reference_measure():
    n = 4096
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    rows = wire_bench.bench_accounting(n, x=x, device="cpu")
    j_compressors = {
        "identity": jcomp.Identity(),
        "quant_fine": jcomp.UniformQuantizer(levels=1000, vmin=-10, vmax=10,
                                             clip=True),
        "quant_coarse": jcomp.UniformQuantizer(levels=10, vmin=-1, vmax=1,
                                               clip=True),
        "sign": jcomp.ScaledSign(),
        "top_0.1": jcomp.TopK(fraction=0.1),
        "rand_0.5": jcomp.RandD(fraction=0.5),
    }
    assert [r[0] for r in rows] == list(j_compressors)
    for (name, nominal, measured, ratio) in rows:
        C = j_compressors[name]
        y = C(jax.random.PRNGKey(2), jnp.asarray(x))
        assert nominal == C.wire_bits_per_scalar(), name
        assert measured == 8.0 * j_measure_tree_bytes(C, y) / n, name
        assert ratio == measured / nominal


def test_wire_bench_kernels_round_trip_on_the_cpu():
    rows = wire_bench.bench_kernels([4096, 40000], [1, 4, 10], 1, "cpu")
    assert [(r[1], r[2]) for r in rows] == [
        (n, b) for n in (4096, 40000) for b in (1, 4, 10)]
    assert all(r[0] == "plain" and r[3] > 0 and r[4] > 0 for r in rows)


def test_kernel_bench_on_the_cpu_claims_no_device_share(capsys):
    out = kernel_bench.main(device="cpu")
    assert out["device"] == "cpu" and out["route"] == "plain"
    assert out["quantize_ef"]["bound_share"] is None
    assert out["flash_attention"]["bound_share"] is None
    # the card's bounds: 13 B per value at 3.35 TB/s; three TF32 products
    assert out["quantize_ef"]["bound_us"] == pytest.approx(
        (1 << 20) * 13 / 3.35e12 * 1e6)
    assert out["flash_attention"]["bound_us"] == pytest.approx(
        3 * 4 * 4 * 1024 * 1024 * 128 / 2 / 495e12 * 1e6)
    text = capsys.readouterr().out
    assert "819e9" not in text and "tpu" not in text.lower()
    assert "not measured (CPU)" in text
