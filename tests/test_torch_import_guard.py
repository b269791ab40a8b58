"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked otherwise."""
import ast
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, convert, resolve_device
from repro_torch.bench import common, fig4_trajectory, sim_scale
from repro_torch.bench import table1_error_feedback, table2_space_comparison
from repro_torch.bench import table_fault_tolerance, table_lossy_ef, table_plane_agg
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.core.deploy import DeployFedLT
from repro_torch.data import logistic, synthetic
from repro_torch.examples import satellite_constellation, train_federated_lm
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.obs import report

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_GUARD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "repro.")) for k in sys.modules
               if sys.modules[k] is not None)
import torch.distributed as dist
assert not dist.is_initialized()   # no module makes a process group at import
print(" ".join(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 87                  # every module of the port
    for mod in ("moe", "mamba2", "rwkv6"):   # the MoE, Mamba2 and RWKV6 families
        assert f"repro_torch.models.{mod}" in names
    for mod in ("launch.mesh", "launch.sharding", "launch.dryrun", "bench.roofline",
                "bench.dryrun_all", "bench.perf_iterations"):   # the launch slice
        assert f"repro_torch.{mod}" in names
    for pkg in ("constellation", "sim", "channel", "faults", "obs", "bench",
                "models", "configs", "launch", "examples"):
        assert (PORT / pkg / "__init__.py").exists()   # walked, not skipped


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("entry", [
    lambda: resolve_device(),
    lambda: logistic.generate(0, n_agents=2, m=4, dim=3),
    lambda: convert.data_from_numpy({"a": np.zeros(3, np.float32)}),
    lambda: api.Experiment("walker-kiruna", algorithm=None),
    lambda: report.run_canonical("sync-lossless"),
    lambda: sim_scale.lossy_round(20, rounds=1),
    lambda: sim_scale.round_pipeline(20, rounds=1),
    lambda: transformer.init_params(smoke_variant(ARCHS["h2o-danube-3-4b"])),
    lambda: transformer.init_cache(smoke_variant(ARCHS["h2o-danube-3-4b"]), 1, 8),
    lambda: convert.model_params_from_jax({"w": np.zeros(3, np.float32)}),
    lambda: common.problem(scale=0.05),
    lambda: table1_error_feedback.run(mc_runs=1, rounds=1, scale=0.05),
    lambda: table2_space_comparison.run(mc_runs=1, rounds=1, scale=0.2),
    lambda: fig4_trajectory.run(rounds=1, scale=0.05),
    lambda: satellite_constellation.main(rounds=1),
    lambda: table_lossy_ef.run([0.0], rounds=1, dim=2, m=2, verbose=False),
    lambda: table_fault_tolerance.run([0.0], rounds=1, dim=2, m=2, verbose=False),
    lambda: table_plane_agg.run_sweep(table_plane_agg.WALKER_ARMS[:1], rounds=1,
                                      n_agents=100, dim=2, m=2),
    lambda: report.convgate(str(ROOT / "CONV_reference.json"), out=io.StringIO()),
    lambda: train.main(["--arch", "stablelm-1.6b", "--smoke", "--rounds", "1"]),
    lambda: DeployFedLT(cfg=smoke_variant(ARCHS["stablelm-1.6b"])).init(2),
    lambda: synthetic.make_batch(smoke_variant(ARCHS["stablelm-1.6b"]),
                                 synthetic.seeded(0), 1, 8),
    lambda: train_federated_lm.main(["--rounds", "1"]),
    lambda: convert.deploy_state_from_jax(None),
], ids=["resolve_device", "generate", "data_from_numpy", "Experiment",
        "run_canonical", "lossy_round", "round_pipeline", "init_params",
        "init_cache", "model_params_from_jax", "bench_problem", "table1",
        "table2", "fig4", "constellation_example", "table_lossy_ef",
        "table_fault_tolerance", "table_plane_agg", "convgate", "launch_train",
        "deploy_init", "make_batch", "train_federated_lm_example",
        "deploy_state_from_jax"])
def test_entry_point_without_device_raises_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_cpu_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    data, _ = logistic.generate(0, n_agents=2, m=4, dim=3, device="cpu")
    assert data["a"].device.type == "cpu"
    # full float32 in matrix products: TF32 would move the e_K curves
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
