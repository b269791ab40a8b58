"""Where the port runs: the CUDA card, or the CPU only when asked.

There is no fallback.  An entry point given no device runs on the card,
and raises when there is none; ``device="cpu"`` is honoured only when a
caller passes it, as the tests do, and so is ``device="meta"``: tensors
with shapes and dtypes and no storage, on which the kernel wrappers
allocate their outputs and launch nothing (the dry-run's device,
``launch/dryrun.py``).
"""
from __future__ import annotations

import subprocess

import torch
from torch.distributed.tensor import DTensor


def set_float32_precision() -> None:
    """Keep float32 matrix products and convolutions in full float32.

    TF32 keeps about three decimal digits; on Hopper it would move the
    e_K curves away from the JAX reference, so it stays off.
    """
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (or implied) and absent."""
    set_float32_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but CUDA is not available")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    return dev


def cap_test_worker_threads() -> None:
    """Run torch's CPU ops on one intra-op thread in a pytest-xdist worker
    (``PYTEST_XDIST_WORKER`` set), and leave them alone elsewhere.

    Only the port's test modules call it, when they are imported.  Under
    ``-n 6`` each worker imports every test module, and at torch's default
    of a thread per core the workers' pools (which spin while they wait)
    competed for the cores with one another and with the JAX package's
    slowest test file, which then took the longest of any worker.
    """
    import os
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed.tensor.DTensor`` (a tensor
    laid out over a device mesh)."""
    return isinstance(t, DTensor)


def _holds_cuda(x) -> bool:
    """Whether ``x`` is, or holds in its tuples, lists and dicts, a CUDA
    tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return any(_holds_cuda(v) for v in x)
    return False


def block_until_ready(x) -> None:
    """Wait for the card's queued work when ``x`` holds a CUDA tensor
    (``torch.cuda.synchronize()``); a no-op for host values.  The port's
    ``jax.block_until_ready``."""
    if _holds_cuda(x):
        torch.cuda.synchronize()


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``"cpu"``: what a
    recorded time is written beside."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[device.index or 0].strip()
