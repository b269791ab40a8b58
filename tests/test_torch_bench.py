"""The port's benchmark harness against the JAX package's ``repro.bench``.

Registry names and groups, the metric schema, the emitted JSON (less the
port's ``device`` key), the comparator's verdicts and report text on the
reference test's synthetic cases, ``compare``'s exit codes, and the
registry's mapping from the benchmark functions' dicts to metrics (with
the ``sim_scale`` functions replaced by the same stubs in both packages)
must be the reference's exactly.  The kernel benchmarks run their plain
versions here (CPU tensors) and must give the committed reference
baseline's tiny metric keys, units and flags.  No timing is compared.
"""
import contextlib
import gc
import io
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from repro.bench import BENCHMARKS as J_BENCHMARKS
from repro.bench import metric as j_metric
from repro.bench.__main__ import emit as j_emit
from repro.bench.__main__ import main as j_main
from repro.bench.compare import compare_dirs as j_compare_dirs
from repro.bench.compare import format_report as j_format_report
from repro.bench.compare import main as j_compare_main
from repro_torch.bench import BENCHMARKS, metric, run_benchmarks
from repro_torch.bench import compare, sim_scale, timing
from repro_torch.bench.__main__ import emit
from repro_torch.bench.__main__ import main as bench_main
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BASELINE = ROOT / "src" / "repro_torch" / "bench" / "baseline"


def test_registry_names_and_groups_equal_reference():
    assert {n: b.group for n, b in BENCHMARKS.items()} == \
        {n: b.group for n, b in J_BENCHMARKS.items()}
    assert len(BENCHMARKS) == 7
    for name, b in BENCHMARKS.items():
        assert name == b.name and name.startswith(f"{b.group}.")
        assert b.description


def _listed(main, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--list"], **kw) == 0
    return [tuple(line.split()[:2]) for line in buf.getvalue().splitlines()]


def test_list_prints_the_reference_names_and_groups():
    assert _listed(bench_main) == _listed(j_main)


@pytest.mark.parametrize("args", [
    (1.5, "x", True, True), (2, "ms", False, False), (0.0, "GB/s", True, False),
])
def test_metric_schema_equals_reference(args):
    v, unit, hib, gate = args
    assert metric(v, unit, higher_is_better=hib, gate=gate) == \
        j_metric(v, unit, higher_is_better=hib, gate=gate)
    assert metric(v, unit, higher_is_better=hib) == \
        j_metric(v, unit, higher_is_better=hib)


def test_emit_writes_reference_json_plus_device(tmp_path):
    results = {"sim": {"sim.fake": {
        "speedup": metric(2.0, "x", higher_is_better=True, gate=True)}},
        "kernels": {"kernels.fake": {
            "gbps": metric(3.25, "GB/s", higher_is_better=True)}}}
    for tiny in (False, True):
        emit(results, str(tmp_path / "port"), tiny, "cpu")
        j_emit(results, str(tmp_path / "ref"), tiny)
        for group in ("sim", "kernels"):
            port = json.loads((tmp_path / "port" / f"BENCH_{group}.json")
                              .read_text())
            ref = json.loads((tmp_path / "ref" / f"BENCH_{group}.json")
                             .read_text())
            assert port.pop("device") == "cpu"
            assert port == ref


# the reference test's synthetic cases: (group, base benches, new benches);
# None as a directory means no file there at all
def _gated(v, hib):
    return {"sim.fake": {"m": metric(v, "x", higher_is_better=hib,
                                     gate=True)}}


CASES = {
    **{f"gate-hib{hib}-{new}": ("sim", _gated(2.0, hib), _gated(new, hib))
       for hib, new in [(True, 2.0), (True, 1.7), (True, 1.5), (True, 2.6),
                        (False, 2.3), (False, 2.5), (False, 1.5)]},
    "ungated-never-fails": (
        "kernels",
        {"kernels.fake": {"gbps": metric(10.0, "GB/s",
                                         higher_is_better=True)}},
        {"kernels.fake": {"gbps": metric(1.0, "GB/s",
                                         higher_is_better=True)}}),
    "tiny-subset-of-full": (
        "sim",
        {"sim.fake": {
            "n64_speedup": metric(1.4, "x", higher_is_better=True, gate=True),
            "n10000_sats_per_sec": metric(9.0, "sats/s",
                                          higher_is_better=True)}},
        {"sim.fake": {
            "n64_speedup": metric(1.35, "x", higher_is_better=True,
                                  gate=True)}}),
    "gated-metric-absent": (
        "sim",
        {"sim.fake": {"speedup": metric(2.8, "x", higher_is_better=True,
                                        gate=True)}},
        {}),
    "missing-baseline-files": ("sim", None, _gated(1.0, True)),
    "missing-fresh-files": ("sim", _gated(1.0, True), None),
}


def _rows(verdicts):
    nan = lambda x: None if math.isnan(x) else x    # noqa: E731
    return [(v.group, v.bench, v.metric, v.status, nan(v.new), nan(v.base))
            for v in verdicts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_equals_reference(tmp_path, case):
    group, base, new = CASES[case]
    dirs = {}
    for pkg, write in (("port", lambda r, d: emit(r, d, False, "cpu")),
                       ("ref", lambda r, d: j_emit(r, d, tiny=False))):
        for side, benches in (("base", base), ("new", new)):
            d = tmp_path / pkg / side
            if benches is not None:
                write({group: benches}, str(d))
            dirs[pkg, side] = str(d)
    got_pass, got = compare.compare_dirs(dirs["port", "new"],
                                         dirs["port", "base"], tol=0.2)
    want_pass, want = j_compare_dirs(dirs["ref", "new"], dirs["ref", "base"],
                                     tol=0.2)
    assert got_pass == want_pass
    assert _rows(got) == _rows(want)
    assert compare.format_report(got, 0.2) == j_format_report(want, 0.2)
    if case.startswith("gate-"):
        assert "gated" in compare.format_report(got, 0.2)
    if case == "gated-metric-absent":
        assert not got_pass and got[0].status == "regression"


@pytest.mark.parametrize("new_value,rc", [(1.0, 1), (2.0, 0)])
def test_compare_main_exit_codes(tmp_path, capsys, new_value, rc):
    for pkg, write in (("port", lambda r, d: emit(r, d, False, "cpu")),
                       ("ref", lambda r, d: j_emit(r, d, tiny=False))):
        write({"sim": _gated(2.0, True)}, str(tmp_path / pkg / "base"))
        write({"sim": _gated(new_value, True)}, str(tmp_path / pkg / "new"))
    capsys.readouterr()
    got = compare.main([str(tmp_path / "port" / "new"), "--baseline",
                        str(tmp_path / "port" / "base")])
    port_out = capsys.readouterr().out
    want = j_compare_main([str(tmp_path / "ref" / "new"), "--baseline",
                           str(tmp_path / "ref" / "base")])
    assert got == want == rc
    assert port_out == capsys.readouterr().out


def test_compare_defaults_to_the_ports_baseline():
    assert Path(compare.BASELINE_DIR) == BASELINE


# -- the registry's mapping from benchmark dicts to metrics ------------------

# every key a registered sim benchmark reads from its function's dict
STUB_KEYS = sorted({
    "round_s_unfused", "round_s_fused", "speedup", "sats_per_sec_fused",
    "round_s_lossless", "round_s_lossy", "channel_overhead",
    "lossy_uplink_speedup", "lost", "attempted",
    "round_s_fast", "round_s_oracle", "sync_speedup", "async_speedup",
    "s_disabled", "s_enabled", "overhead", "events",
    "sync_active", "sync_s", "async_n", "async_s"})
STUBBED = ("bench_round_pipeline", "bench_lossy_round", "bench_fast_round",
           "bench_trace_overhead", "bench_scale")


def _stub(n_sats, *args, **kwargs):
    # distinct per key and scale; async_speedup past the 10x cap
    out = {k: 0.5 + i + n_sats / 1e4 for i, k in enumerate(STUB_KEYS)}
    out["async_speedup"] = 23.0 + n_sats / 1e4
    return out


@pytest.fixture(scope="module")
def reference_sim_scale():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import sim_scale as bss
    return bss


@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("name", sorted(n for n in BENCHMARKS
                                        if n.startswith("sim.")))
def test_sim_benchmark_metrics_equal_reference(monkeypatch, reference_sim_scale,
                                               name, tiny):
    for fn in STUBBED:
        monkeypatch.setattr(sim_scale, fn, _stub)
        monkeypatch.setattr(reference_sim_scale, fn, _stub)
    got = BENCHMARKS[name].fn(tiny, CPU)
    assert got == J_BENCHMARKS[name].fn(tiny)
    assert got


def _reference_baseline(group):
    return json.loads((ROOT / f"BENCH_{group}.json").read_text())


@pytest.mark.parametrize("name,tiny_n", [("kernels.pack_throughput", 1 << 16),
                                         ("kernels.fused_pipeline", 1 << 18)])
def test_kernel_benchmarks_tiny_keys_equal_reference_baseline(name, tiny_n):
    got = BENCHMARKS[name].fn(True, CPU)
    full = _reference_baseline("kernels")["benchmarks"][name]
    want = {k: v for k, v in full.items() if k.endswith(f"_n{tiny_n}")}
    assert sorted(got) == sorted(want)
    for k, m in got.items():
        assert {f: m[f] for f in ("unit", "higher_is_better", "gate")} == \
            {f: want[k][f] for f in ("unit", "higher_is_better", "gate")}
        assert math.isfinite(m["value"]) and m["value"] > 0


def test_run_benchmarks_has_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_benchmarks(["kernels.pack_throughput"], tiny=True, verbose=False)
    with pytest.raises(KeyError, match="unknown"):
        run_benchmarks(["kernels.nope"], device="cpu", verbose=False)


def test_run_benchmarks_groups_on_the_cpu(capsys):
    out = run_benchmarks(["kernels.pack_throughput"], tiny=True, device="cpu")
    assert list(out) == ["kernels"]
    assert sorted(out["kernels"]["kernels.pack_throughput"]) == [
        "pack_gbps_n65536", "unpack_gbps_n65536"]
    assert "# kernels.pack_throughput" in capsys.readouterr().out


# -- timing -------------------------------------------------------------------

def _counting():
    calls = []

    def fn():
        calls.append(gc.isenabled())
        return torch.zeros(2), [torch.ones(1)], {"a": 1.0}
    return fn, calls


@pytest.mark.parametrize("gc_on", [True, False])
def test_time_fn_calls_and_gc(gc_on):
    was = gc.isenabled()
    (gc.enable if gc_on else gc.disable)()
    try:
        fn, calls = _counting()
        s = timing.time_fn(fn, reps=4, warmup=2)
        assert len(calls) == 6 and s >= 0.0
        assert calls[:2] == [gc_on] * 2 and calls[2:] == [False] * 4
        assert gc.isenabled() == gc_on
        fa, ca = _counting()
        fb, cb = _counting()
        sa, sb = timing.time_pair(fa, fb, reps=3, warmup=1)
        assert len(ca) == len(cb) == 4 and sa >= 0.0 and sb >= 0.0
        assert ca[1:] == cb[1:] == [False] * 3
        assert gc.isenabled() == gc_on
    finally:
        (gc.enable if was else gc.disable)()


def test_gbps():
    assert timing.gbps(4e9, 2.0) == 2.0
    assert math.isfinite(timing.gbps(1.0, 0.0))


# -- the committed port baselines ---------------------------------------------

@pytest.mark.parametrize("group", ["sim", "kernels"])
def test_port_baselines_match_reference_schema(group):
    port = json.loads((BASELINE / f"BENCH_{group}.json").read_text())
    ref = _reference_baseline(group)
    assert port["schema"] == ref["schema"] == 1
    assert port["tiny"] is False
    assert "NVIDIA" in port["device"] and "W" in port["device"]
    assert sorted(port["benchmarks"]) == sorted(ref["benchmarks"])
    flags = ("unit", "higher_is_better", "gate")
    for bench, metrics in ref["benchmarks"].items():
        assert sorted(port["benchmarks"][bench]) == sorted(metrics)
        for m, d in metrics.items():
            got = port["benchmarks"][bench][m]
            assert {f: got[f] for f in flags} == {f: d[f] for f in flags}
            assert math.isfinite(got["value"])
