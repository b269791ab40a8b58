"""Blocked flash attention: causal, sliding window, tanh softcap, GQA.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` with the
positions of the JAX model's ``attention_chunked`` made explicit:

    s   = q·k / √D                     (float32)
    s   = cap·tanh(s / cap)            with a softcap
    s   = −1e30 unless k_pos ≤ q_pos (causal) and k_pos > q_pos − window
    out = softmax(s)·v                 cast to q's dtype once

q is (B, Sq, H, D), k and v are (B, Sk, Hkv, D) with H % Hkv == 0, and head
h reads KV head ``h // (H // Hkv)``.  ``q_pos`` (Sq,) and ``k_pos`` (Sk,)
default to ``arange``, which gives exactly the Pallas kernel's function.
The Pallas kernel takes q, k and v to float32 before its products, and so
do the CUDA kernel and the plain version; the JAX model's chunked backend
instead rounds bf16 scores before taking them to float32.

A tensor on the CPU goes to the plain version in :mod:`.ref`; a tensor on
the card goes to the CUDA kernel in ``csrc/flash_attention.cu`` (float32
or bf16, D ≤ 128), which reads q, k and v through their strides.
"""
from __future__ import annotations

import math

import torch

from . import _build, ref

__all__ = ["flash_attention"]

MAX_HEAD_DIM = 128


def _positions(pos, n: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    pos = torch.as_tensor(pos, device=device)
    if pos.shape != (n,):
        raise ValueError(f"positions of shape {tuple(pos.shape)}, expected ({n},)")
    return pos.to(torch.int32).contiguous()


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal: bool = True,
                    window=None, softcap=None):
    """(B, Sq, H, D) attention of q over k/v (B, Sk, Hkv, D); returns
    (B, Sq, H, D) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, H, D), k and v alike")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and "
                         "head_dim must agree and H be a multiple of Hkv")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    q_pos = _positions(q_pos, sq, q.device)
    k_pos = _positions(k_pos, sk, q.device)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, softcap=softcap)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    if b * h > 65535 or max(sq, sk) >= 2**31 or sk == 0:
        raise ValueError(f"B·H = {b * h} must be <= 65535 and 0 < Sk < 2**31")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    _build.launch("flash_attention", q, k, v, out, q_pos, k_pos,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  b, h, hkv, sq, sk, d, int(causal), window or 0,
                  1.0 / math.sqrt(d), float(softcap or 0.0),
                  int(q.dtype == torch.bfloat16))
    return out
