"""PyTorch/CUDA port of the federated constellation reproduction.

A second package beside the JAX one (``repro``), with the same module
paths, so each port module sits where its counterpart does.  The port
imports ``torch`` and ``numpy`` only.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`);
the TPU kernels of the path are hand-written CUDA kernels under
``repro_torch/kernels/csrc``, with plain PyTorch versions beside them in
:mod:`repro_torch.kernels.ref`.
"""
from .device import resolve_device, set_float32_precision

__all__ = ["resolve_device", "set_float32_precision"]
