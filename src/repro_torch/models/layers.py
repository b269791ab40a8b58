"""Basic layers: norms, MLPs, embeddings, positional encodings.

Counterpart of ``repro.models.layers``, with the JAX package's layouts
and arithmetic: norms and angles in float32, ``gelu`` the tanh
approximation (``jax.nn.gelu``'s default; torch's is exact unless asked).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import is_dtensor


def rms_norm(x, weight, eps: float = 1e-5):
    """x·rsqrt(mean(x²) + eps)·(1 + weight), in float32, cast back to x's
    dtype: the weight is an offset from 1, zeros at init."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(x.dtype)


def init_normal(shape, scale: float, dtype, *, generator=None, device=None):
    """N(0, 1)·scale drawn in float32 from ``generator``, cast to ``dtype``
    (the JAX package's scales and per-leaf dtypes; not its numbers)."""
    w = torch.randn(tuple(shape), generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def init_rms_norm(d: int, *, device=None, lead=()):
    """Norm weights: float32 zeros whatever the model's dtype."""
    return torch.zeros(tuple(lead) + (d,), device=device)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def init_mlp(d_model: int, d_ff: int, gated: bool, dtype, *, generator=None,
             device=None, lead=()):
    kw = dict(generator=generator, device=device)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    p = {"up": init_normal(tuple(lead) + (d_model, d_ff), s_in, dtype, **kw),
         "down": init_normal(tuple(lead) + (d_ff, d_model), s_out, dtype, **kw)}
    if gated:
        p["gate"] = init_normal(tuple(lead) + (d_model, d_ff), s_in, dtype, **kw)
    return p


def mlp(params, x, act: str, gated: bool):
    h = x @ params["up"]
    if gated:
        h = act_fn(act)(x @ params["gate"]) * h
    else:
        h = act_fn(act)(h)
    return h @ params["down"]


def init_embed(vocab: int, d_model: int, dtype, *, generator=None, device=None):
    return {"table": init_normal((vocab, d_model), 0.02, dtype,
                                 generator=generator, device=device)}


def embed(params, tokens):
    table = params["table"]
    if is_dtensor(table) or is_dtensor(tokens):
        return _embed_on_mesh(table, tokens)
    return table[tokens]


def _embed_on_mesh(table, tokens):
    """The lookup on DTensors as a vocab-parallel embedding, on each rank's
    local shards (``launch.sharding.map_local``): each rank looks up the
    tokens that fall in its vocab rows, zero elsewhere, and the result is a
    partial sum over the mesh dims that shard the vocab (reduced where the
    residual stream is made whole).  The table's feature dim is gathered
    first; the tokens keep their batch sharding, gathered only over the
    vocab dims, so the table's gradient is a partial sum over the batch
    dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..launch.sharding import as_dtensors, map_local

    mesh, (table, tokens) = as_dtensors(table, tokens)
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    t_pl = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    k_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(tokens.placements)]
    t_grad = [Partial() if isinstance(kp, Shard) else tp for tp, kp in zip(t_pl, k_pl)]
    n_vocab = table.shape[0]
    first = 0                        # this rank's first vocab row
    for i in vocab_dims:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= n_vocab // math.prod(mesh.size(i) for i in vocab_dims)

    def local(tab, tok):
        rows = tok.to(torch.int64) - first
        mine = (rows >= 0) & (rows < tab.shape[0])
        out = tab[rows.clamp(0, tab.shape[0] - 1)]
        return torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))

    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(k_pl)]
    return map_local(local, (table, tokens), (t_pl, k_pl), out_pl, (t_grad, k_pl))


def sinusoidal_positions(positions, d_model: int, dtype=torch.float32):
    """positions (...,) int → (..., d_model) sinusoidal encoding."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _inv_freqs(half: int, theta: float, device):
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device) / half)


def rope_angles(positions, rot_dim: int, theta: float):
    """positions (...,) int → cos, sin (..., rot_dim//2), float32."""
    ang = positions[..., None].to(torch.float32) * _inv_freqs(
        rot_dim // 2, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rotary_pct: float = 1.0):
    """x (B, S, H, D); cos/sin (B, S, rot//2) or (B, S, H, rot//2).  Only
    the first ``rot = int(D·rotary_pct)`` (made even) dims rotate; cos and
    sin are cast to x's dtype first, as the JAX package does."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    if rot % 2:
        rot -= 1
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    if cos.dim() == x.dim() - 1:            # broadcast over heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


def mrope_angles(positions3, rot_dim: int, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: positions3 (3, B, S) = (temporal, height, width).

    The rotary spectrum is split into three sections, each rotated by its
    own position stream; section sizes are in half-dim units, scaled to sum
    to rot_dim//2.
    """
    half = rot_dim // 2
    sec = np.array(sections, dtype=np.float64)
    sec = np.round(sec / sec.sum() * half).astype(int)
    sec[2] = half - sec[0] - sec[1]
    stream_idx = torch.as_tensor(
        np.concatenate([np.full(s, i) for i, s in enumerate(sec)]),
        device=positions3.device)
    p_sel = positions3.to(torch.float32)[stream_idx]          # (half, B, S)
    ang = torch.movedim(p_sel, 0, -1) * _inv_freqs(half, theta, positions3.device)
    return torch.cos(ang), torch.sin(ang)
