"""The port's quickstart and serve_lm examples on the CPU, beside the JAX
package's ``examples/quickstart.py`` (run as a script; this file imports
nothing of JAX).

The quickstart's bytes on the wire depend on the quantizer alone, so both
packages' traces carry the same ``bytes_up`` at every traced round.  Its
error curves come from each package's own data draws (the port's generator
is not ``jax.random``), so only their shape is held: in both, the run with
error feedback ends below the run without it.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.examples import quickstart, serve_lm
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("alg1_no_ef", "alg2_ef")


def _rounds(records) -> list:
    return [r for r in records if r.get("kind") == "fl_round"]


def test_quickstart_bytes_equal_the_reference_and_ef_ends_lower(tmp_path, capsys):
    """The reference's example runs in a subprocess (in its own working
    directory, where it writes its traces) while the port's runs here on
    one thread (its rounds are many small ops, which other threads only
    slow down beside other test workers)."""
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    reference = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "quickstart.py")], cwd=ref_dir,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ours = quickstart.main(device="cpu", out_dir=str(tmp_path / "port"))
    finally:
        torch.set_num_threads(threads)
        log = reference.communicate(timeout=600)[0]
    assert reference.returncode == 0, log
    printed = capsys.readouterr().out
    assert printed.count("=== Algorithm") == 2 and "bytes_up" in printed
    theirs = {name: obs.load(str(ref_dir / f"quickstart_{name}.jsonl")) for name in NAMES}
    for name in NAMES:
        assert (tmp_path / "port" / f"quickstart_{name}.jsonl").exists()
        a, b = _rounds(ours[name]), _rounds(theirs[name])
        assert [r["round"] for r in a] == [r["round"] for r in b] == [
            0, 80, 160, 240, 320, 399]
        assert [r["bytes_up"] for r in a] == [r["bytes_up"] for r in b]
        assert a[-1]["bytes_up"] == 500_000
    for runs in (ours, theirs):
        end = {name: _rounds(recs)[-1]["error"] for name, recs in runs.items()}
        assert end["alg2_ef"] < end["alg1_no_ef"], end


@pytest.mark.parametrize("arch", ["granite-20b", "qwen2-vl-7b"])
def test_serve_lm_example_on_the_cpu(arch, capsys):
    gen = serve_lm.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                         "--tokens", "4"], device="cpu")
    out = capsys.readouterr().out
    assert gen.shape == (2, 4) and gen.dtype == torch.int64
    assert int(gen.min()) >= 0 and int(gen.max()) < smoke_variant(ARCHS[arch]).vocab_size
    assert "prefill 2×16" in out and "decoded 3 steps" in out
    assert ("VLM smoke serve uses text tokens only" in out) == (arch == "qwen2-vl-7b")
