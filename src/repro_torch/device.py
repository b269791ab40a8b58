"""Where the port runs: the CUDA card, or the CPU only when asked.

There is no fallback.  An entry point given no device runs on the card,
and raises when there is none; ``device="cpu"`` is honoured only when a
caller passes it, as the tests do.
"""
from __future__ import annotations

import torch


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
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
