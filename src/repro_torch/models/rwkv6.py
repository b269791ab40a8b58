"""RWKV-6 ("Finch") block: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro.models.rwkv6``.  Per head (key/value dim P), state
S ∈ ℝ^{P×P}:

    o_t = r_tᵀ (S_{t−1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t−1} + k_t v_tᵀ,     w_t = exp(−exp(ŵ_t)) ∈ (0,1)

with data-dependent ŵ_t (low-rank LoRA on the token-shifted input) and a
learned per-channel bonus u.  Training and prefill use the chunked
factorized form (per-channel decay cumsum; q̃ = r·e^{cw}, k̃ = k·e^{−cw})
with a loop over the chunk states (JAX: ``lax.scan``); decode is the O(1)
recurrence.  The reference's simplifications are kept: one data-dependent
lerp shared by r, k, v and g, and a decay LoRA of rank 64.  The JAX
package has no Pallas kernel here; neither has the port.

A block given a cache writes the new wkv state and the previous token's
(normed) inputs, ``last_t`` and ``last_c``, **into** the cache's buffers
and returns that same cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .layers import init_normal, init_rms_norm, rms_norm

LORA_RANK = 64
RWKV_CHUNK = 64   # chunk for the wkv scan (bounds the exp-split dynamic range)


def init_rwkv6(cfg, dtype, *, generator=None, device=None, lead=()):
    """The reference's leaves, scales and dtypes (``decay_base``,
    ``bonus_u`` and ``ln_x`` float32); ``lead`` prefixes every shape."""
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)
    lead = tuple(lead)
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        return init_normal(lead + shape, scale, dtype, **kw)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        # time-mix
        "mix_base": full((4, d), 0.5),              # r,k,v,g static lerp
        "mix_lora_a": normal((d, 32), s),
        "mix_lora_b": normal((32, 4 * d), 0.1 / math.sqrt(32)),
        "wr": normal((d, d), s),
        "wk": normal((d, d), s),
        "wv": normal((d, d), s),
        "wg": normal((d, d), s),
        "wo": normal((d, d), s),
        "decay_base": full((d,), -6.0, torch.float32),
        "decay_lora_a": normal((d, LORA_RANK), s),
        "decay_lora_b": normal((LORA_RANK, d), 0.1 / math.sqrt(LORA_RANK)),
        "bonus_u": full((d,), 0.0, torch.float32),
        "ln_x": init_rms_norm(d, device=device, lead=lead),
        # channel-mix
        "ck": normal((d, f), s),
        "cv": normal((f, d), 1.0 / math.sqrt(f)),
        "cr": normal((d, d), s),
        "cmix_r": full((d,), 0.5),
        "cmix_k": full((d,), 0.5),
    }


class RWKVCache(NamedTuple):
    state: torch.Tensor    # (B, H, P, P) float32 — wkv state
    last_t: torch.Tensor   # (B, D) — previous token's time-mix input
    last_c: torch.Tensor   # (B, D) — previous token's channel-mix input


def init_rwkv_cache(batch, cfg, dtype, device=None):
    d = cfg.d_model
    p = cfg.rwkv_head_dim
    return RWKVCache(
        state=torch.zeros((batch, d // p, p, p), device=device),
        last_t=torch.zeros((batch, d), dtype=dtype, device=device),
        last_c=torch.zeros((batch, d), dtype=dtype, device=device))


def _token_shift(x, last):
    """shifted[t] = x[t−1]; shifted[0] = last (zeros at seq start)."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _chunked_wkv(r, k, v, logw, u, chunk: int, state0=None):
    """Chunked linear attention with per-channel decay.

    r,k,v: (B,S,H,P); logw (B,S,H,P) = log decay ∈ (−∞, 0); u (H,P).
    o_t = r_t·(S_{t−1} + diag(u) k_t v_tᵀ);  S_t = diag(w_t)S_{t−1} + k_t v_tᵀ.
    Returns o (B,S,H,P) and the final state (B,H,P,P), float32.
    """
    b, s, h, p = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    nc, q = r.shape[1] // chunk, chunk

    rc, kc, vc, lw = (t.reshape(b, nc, q, h, p) for t in (r, k, v, logw))
    rf, kf, vf = (t.to(torch.float32) for t in (rc, kc, vc))
    lw = lw.to(torch.float32)
    cw = torch.cumsum(lw, dim=2)                # inclusive cumsum within chunk
    total = cw[:, :, -1]                        # (B,nc,H,P)

    # intra-chunk: for j < t: factor exp(cw_{t−1} − cw_j) = exp(cw_t − lw_t − cw_j)
    rt = rf * torch.exp(cw - lw)
    kt = kf * torch.exp(-cw)
    scores = torch.einsum("bcthp,bcjhp->bchtj", rt, kt)
    mask = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)
    scores = scores.masked_fill(~mask, 0.0)     # strictly lower
    y_intra = torch.einsum("bchtj,bcjhp->bcthp", scores, vf)
    # diagonal (bonus) term: o_t += (r_t ⊙ u · k_t) v_t
    diag = (rf * u * kf).sum(dim=-1)
    y_diag = diag[..., None] * vf

    # chunk state: S_chunk = Σ_j diag(exp(total − cw_j)) k_j v_jᵀ
    k_dec = kf * torch.exp(total[:, :, None] - cw)
    s_chunk = torch.einsum("bcqhp,bcqhn->bchpn", k_dec, vf)

    S = r.new_zeros((b, h, p, p), dtype=torch.float32) if state0 is None else state0
    decay_c = torch.exp(total)                  # (B,nc,H,P)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = decay_c[:, c, :, :, None] * S + s_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)             # (B,nc,H,P,P)

    # inter-chunk: o_t += (r_t ⊙ exp(cw_{t−1})) · S_in
    y_inter = torch.einsum("bcqhp,bchpn->bcqhn", rt, S_in)

    y = (y_intra + y_diag + y_inter).reshape(b, nc * q, h, p)[:, :s]
    return y, S


def rwkv6_time_mix(params, cfg, x, cache: Optional[RWKVCache] = None):
    b, s, d = x.shape
    h, p = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    last = cache.last_t if cache is not None else x.new_zeros((b, d))
    prev = _token_shift(x, last)
    delta = prev - x

    # data-dependent lerp (single shared LoRA, split 4 ways)
    lora = torch.tanh(x @ params["mix_lora_a"]) @ params["mix_lora_b"]
    mixes = params["mix_base"][:, None, None] + lora.reshape(b, s, 4, d).permute(2, 0, 1, 3)
    xr, xk, xv, xg = (x + delta * m for m in mixes)

    r = (xr @ params["wr"]).reshape(b, s, h, p)
    k = (xk @ params["wk"]).reshape(b, s, h, p)
    v = (xv @ params["wv"]).reshape(b, s, h, p)
    g = F.silu(xg @ params["wg"])

    dec = params["decay_base"] + (torch.tanh(xk @ params["decay_lora_a"])
                                  @ params["decay_lora_b"]).to(torch.float32)
    logw = -torch.exp(dec.to(torch.float32))            # log w_t ∈ (−∞, 0)
    # clamp so the chunked exp-split factors stay inside float32 range
    # (exp(RWKV_CHUNK·|logw|) ≤ e^80); applied in BOTH train and decode paths
    # so the recurrence semantics stay identical.
    logw = torch.clamp(logw, min=-80.0 / RWKV_CHUNK)
    logw = logw.reshape(b, s, h, p)
    u = params["bonus_u"].reshape(h, p)

    if cache is None or s > 1:
        state0 = None if cache is None else cache.state
        y, S = _chunked_wkv(r, k, v, logw, u, RWKV_CHUNK, state0)
    else:
        k0, v0 = k[:, 0].to(torch.float32), v[:, 0].to(torch.float32)
        kv = k0[..., :, None] * v0[..., None, :]
        o = torch.einsum("bhp,bhpn->bhn", r[:, 0].to(torch.float32),
                         cache.state + u[None, :, :, None] * kv)
        S = torch.exp(logw[:, 0])[..., None] * cache.state + kv
        y = o[:, None]

    y = y.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, params["ln_x"], cfg.norm_eps) * g
    out = y @ params["wo"]
    if cache is not None:
        cache.state.copy_(S)
        cache.last_t.copy_(x[:, -1])
    return out, cache


def rwkv6_channel_mix(params, cfg, x, cache: Optional[RWKVCache] = None):
    b, s, d = x.shape
    last = cache.last_c if cache is not None else x.new_zeros((b, d))
    prev = _token_shift(x, last)
    xk = x + (prev - x) * params["cmix_k"]
    xr = x + (prev - x) * params["cmix_r"]
    kk = torch.square(F.relu(xk @ params["ck"]))
    out = torch.sigmoid(xr @ params["cr"]) * (kk @ params["cv"])
    if cache is not None:
        cache.last_c.copy_(x[:, -1])
    return out, cache
