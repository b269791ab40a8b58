"""Mamba-2 block (SSD — state space duality), chunked for training.

Counterpart of ``repro.models.mamba2``.  Recurrence per head h (state
S ∈ ℝ^{P×N}, P = head dim, N = ssm_state):

    S_t = a_t · S_{t−1} + (Δ_t x_t) ⊗ B_t          a_t = exp(−Δ_t·A_h)
    y_t = S_t C_tᵀ + D_h · x_t

Training and prefill use the chunked form: within a chunk of Q tokens the
quadratic "attention" form with decay mask exp(cum_t − cum_j) (masked
before the exp) gives the intra-chunk output, and chunk-final states are
carried by a loop over the chunks (JAX: ``lax.scan``).  Decode is the O(1)
recurrent update.  The JAX package has no Pallas kernel here; neither has
the port: the chunk products are PyTorch's, in float32 where the
reference's are.

A block given a cache writes the new state and conv carry **into** the
cache's buffers (the transformer hands each layer views of its stacked
slot) and returns that same cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .layers import init_normal, init_rms_norm, rms_norm


def init_mamba2(cfg, dtype, *, generator=None, device=None, lead=()):
    """The reference's leaves, scales and dtypes: in_proj, conv_w and
    out_proj drawn in ``dtype``; conv_b zeros in ``dtype``; a_log =
    log(linspace(1, 16, H)), d_skip ones, dt_bias and norm_scale zeros, all
    float32.  ``lead`` prefixes every shape."""
    d = cfg.d_model
    d_in = cfg.ssm_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_n_groups
    conv_dim = d_in + 2 * g * n
    kw = dict(generator=generator, device=device)
    lead = tuple(lead)
    a_log = torch.from_numpy(np.log(np.linspace(1.0, 16.0, h, dtype=np.float32)))
    return {
        # fused input projection: [x (d_in), z (d_in), B (g·n), C (g·n), dt (h)]
        "in_proj": init_normal(lead + (d, 2 * d_in + 2 * g * n + h),
                               1.0 / math.sqrt(d), dtype, **kw),
        "conv_w": init_normal(lead + (cfg.ssm_conv, conv_dim), 0.2, dtype, **kw),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "a_log": a_log.to(device).expand(lead + (h,)).clone(),
        "d_skip": torch.ones(lead + (h,), device=device),
        "dt_bias": torch.zeros(lead + (h,), device=device),
        "norm_scale": init_rms_norm(d_in, device=device, lead=lead),
        "out_proj": init_normal(lead + (d_in, d), 1.0 / math.sqrt(d_in), dtype, **kw),
    }


class SSMCache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) float32
    conv: torch.Tensor       # (B, conv_w − 1, conv_dim)


def init_ssm_cache(batch, cfg, dtype, device=None):
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_n_groups
    conv_dim = cfg.ssm_inner + 2 * g * n
    return SSMCache(
        state=torch.zeros((batch, h, p, n), device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device))


def _split_proj(cfg, proj):
    d_in, g, n = cfg.ssm_inner, cfg.ssm_n_groups, cfg.ssm_state
    xz, rest = proj[..., : 2 * d_in], proj[..., 2 * d_in:]
    x, z = xz[..., :d_in], xz[..., d_in:]
    bc, dt = rest[..., : 2 * g * n], rest[..., 2 * g * n:]
    return x, z, bc, dt


def _causal_conv(u, w, b, carry=None):
    """u: (B, S, C); depthwise causal conv width K. carry: (B, K−1, C)."""
    kw = w.shape[0]
    if carry is None:
        pad = u.new_zeros((u.shape[0], kw - 1, u.shape[-1]))
    else:
        pad = carry.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    out = sum(full[:, i: i + u.shape[1]] * w[i] for i in range(kw))
    new_carry = full[:, -(kw - 1):] if kw > 1 else None
    return F.silu(out + b), new_carry


def _pad_seq(t, pad: int):
    """Zeros after the sequence axis (axis 1) of a (B, S, ...) tensor."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _ssd_chunked(xh, dt, a, Bm, Cm, d_skip, chunk: int, state0=None):
    """Chunked SSD scan.

    xh (B,S,H,P), dt (B,S,H), a = exp(A_log) (H,), Bm/Cm (B,S,G,N).
    Returns y (B,S,H,P) float32 and the final state (B,H,P,N) float32.
    The G groups' B and C serve H/G heads each: the products that only
    read B and C are taken per group and broadcast over its heads (the
    reference repeats B and C per head first; the numbers are the same).
    """
    b, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        xh, dt, Bm, Cm = (_pad_seq(t, pad) for t in (xh, dt, Bm, Cm))
    nc = xh.shape[1] // chunk
    q = chunk

    def to_chunks(t):
        return t.reshape((b, nc, q) + tuple(t.shape[2:]))

    xc, dtc = to_chunks(xh), to_chunks(dt)
    Bc, Cc = to_chunks(Bm), to_chunks(Cm)                 # (B,nc,Q,G,N)

    loga = -dtc.to(torch.float32) * a                     # (B,nc,Q,H) ≤ 0
    cum = torch.cumsum(loga, dim=2)                       # inclusive
    total = cum[:, :, -1]                                 # (B,nc,H)

    # intra-chunk: scores[t,j] = (C_t·B_j)·exp(cum_t − cum_j)·dt_j, j ≤ t
    scores = torch.einsum("bctgn,bcjgn->bcgtj", Cc, Bc).to(torch.float32)
    scores = scores.repeat_interleave(rep, dim=2) if rep > 1 else scores
    cum_h = cum.permute(0, 1, 3, 2)                       # (B,nc,H,Q)
    decay = cum_h[..., :, None] - cum_h[..., None, :]     # (B,nc,H,t,j)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    # mask BEFORE exp: upper-triangle decays are positive and would
    # overflow, poisoning the backward pass with inf·0 = NaN.
    w = torch.exp(decay.masked_fill(~mask, -math.inf)) * scores
    w = w * dtc.to(torch.float32).permute(0, 1, 3, 2)[..., None, :]
    y_intra = torch.einsum("bchtj,bcjhp->bcthp", w.to(xc.dtype), xc)

    # chunk-final contributions: S_chunk = Σ_j exp(total − cum_j)·dt_j·x_j⊗B_j
    k_dec = torch.exp(total[:, :, None] - cum) * dtc.to(torch.float32)  # (B,nc,Q,H)
    xk = (k_dec[..., None] * xc.to(torch.float32)).reshape(b, nc, q, g, rep, p)
    s_chunk = torch.einsum("bcqgrp,bcqgn->bcgrpn", xk, Bc.to(torch.float32))
    s_chunk = s_chunk.reshape(b, nc, h, p, n)

    # inter-chunk recurrence over chunk states (JAX: lax.scan)
    S = xh.new_zeros((b, h, p, n), dtype=torch.float32) if state0 is None else state0
    decay_c = torch.exp(total)                             # (B,nc,H)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = decay_c[:, c, :, None, None] * S + s_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)                        # (B,nc,H,P,N)

    # inter-chunk output: y_t += C_t · (exp(cum_t) · S_in)
    q_dec = torch.exp(cum)                                 # (B,nc,Q,H)
    cq = Cc.to(torch.float32).repeat_interleave(rep, dim=3) * q_dec[..., None]
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cq, S_in)

    y = y_intra.to(torch.float32) + y_inter + d_skip[:, None] * xc.to(torch.float32)
    y = y.reshape(b, nc * q, h, p)[:, :s]
    return y, S


def mamba2_block(params, cfg, x, cache: Optional[SSMCache] = None):
    """x: (B, S, D) → (B, S, D); cache for decode.  Returns (y, cache): a
    given cache's buffers hold the new state and conv carry."""
    b, s, d = x.shape
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_n_groups
    proj = x @ params["in_proj"]
    xi, z, bc, dt_raw = _split_proj(cfg, proj)

    conv_in = torch.cat([xi, bc], dim=-1)
    conv_out, conv_carry = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                        None if cache is None else cache.conv)
    xi = conv_out[..., : cfg.ssm_inner]
    bc = conv_out[..., cfg.ssm_inner:]
    Bm = bc[..., : g * n].reshape(b, s, g, n)
    Cm = bc[..., g * n:].reshape(b, s, g, n)

    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])     # (B,S,H)
    a = torch.exp(params["a_log"])                                    # (H,)
    xh = xi.reshape(b, s, h, p)

    if cache is None or s > 1:
        state0 = None if cache is None else cache.state
        y, S = _ssd_chunked(xh, dt, a, Bm, Cm, params["d_skip"], cfg.chunk_size,
                            state0)
    else:
        # decode: one recurrent step
        a_t = torch.exp(-dt[:, 0] * a)                                # (B,H)
        x0 = xh[:, 0].to(torch.float32)
        B0 = Bm[:, 0].to(torch.float32).repeat_interleave(h // g, dim=1)
        C0 = Cm[:, 0].to(torch.float32).repeat_interleave(h // g, dim=1)
        upd = (dt[:, 0, :, None] * x0)[..., None] * B0[:, :, None, :]
        S = a_t[:, :, None, None] * cache.state + upd
        y = torch.einsum("bhpn,bhn->bhp", S, C0)
        y = (y + params["d_skip"][None, :, None] * x0)[:, None]

    y = y.reshape(b, s, cfg.ssm_inner).to(x.dtype)
    y = y * F.silu(z)                            # gated
    y = rms_norm(y, params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if cache is not None:
        cache.state.copy_(S)
        cache.conv.copy_(conv_carry)
    return out, cache
