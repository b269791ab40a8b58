"""Attention: GQA/MQA/MHA with RoPE/M-RoPE, sliding window, KV cache.

Counterpart of ``repro.models.attention``.  Two backends:

  * ``xla``     — plain einsum attention (:func:`attention_xla`), the oracle.
  * ``chunked`` — the hand-written flash kernel through ``ops.attention``
                  with the real query and key positions; on the CPU it
                  takes the kernel's plain version.  In the JAX package
                  this backend is ``attention_chunked``, a pure-JAX flash
                  loop; its Pallas kernel "implements the same contract",
                  and on the card the port's chunked backend is the kernel.

One-token decode runs :func:`attention_xla`, plain: the JAX package's
``_decode_attention`` is the same function.

Caches carry their ``length`` as a Python int (every layer has seen the
same tokens), so no step reads a device scalar back.  :func:`attention_block`
updates the cache buffers it is given **in place** and returns them (JAX
returns new buffers); the serving steps own their cache and hand it on.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels import ops
from ..kernels.ref import NEG_INF, attention_mask
from .layers import apply_rope, init_normal, init_rms_norm, rms_norm


def init_attention(cfg, dtype, *, generator=None, device=None, lead=()):
    """wq, wk, wv, wo ~ N(0, 1)/√fan_in in ``dtype``, and float32 zero q/k
    norms with ``qk_norm``, as ``repro.models.attention``; ``lead`` prefixes
    every shape (the repeats of a stacked slot)."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    kw = dict(generator=generator, device=device)
    lead = tuple(lead)
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(qd)
    p = {"wq": init_normal(lead + (d, qd), s, dtype, **kw),
         "wk": init_normal(lead + (d, kvd), s, dtype, **kw),
         "wv": init_normal(lead + (d, kvd), s, dtype, **kw),
         "wo": init_normal(lead + (qd, d), so, dtype, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(cfg.head_dim, device=device, lead=lead)
        p["k_norm"] = init_rms_norm(cfg.head_dim, device=device, lead=lead)
    return p


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _grouped_scores(q, k):
    """(B, Sq, H, D) · (B, Sk, Hkv, D) → (B, Hkv, n_rep, Sq, Sk): head h
    against KV head h // n_rep, without an expanded copy of k."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    return torch.einsum("bqgrd,bkgd->bgrqk", qg, k)


def _grouped_out(probs, v):
    """(B, Hkv, n_rep, Sq, Sk) · (B, Sk, Hkv, D) → (B, Sq, H, D)."""
    b, hkv, n_rep, sq, _ = probs.shape
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, sq, hkv * n_rep, v.shape[-1])


def attention_xla(q, k, v, q_pos, k_pos, *, window=None, softcap=None):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) → (B,Sq,H,D): scores in q's dtype
    taken to float32, softmax in float32, probabilities cast to v's dtype
    for P·V — the JAX package's ``attention_xla`` step for step."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _grouped_scores(q, k).to(torch.float32) * scale
    scores = _softcap(scores, softcap)
    ok = attention_mask(q_pos, k_pos, causal=True, window=window)
    scores = scores.masked_fill(~ok, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs.to(v.dtype), v)


class KVCache(NamedTuple):
    """KV cache; for sliding-window layers S_max = window and the buffer is
    a ring (absolute positions tracked in ``pos``)."""
    k: torch.Tensor      # (B, S_max, Hkv, D)
    v: torch.Tensor
    pos: torch.Tensor    # (S_max,) int32 absolute position of each slot
    length: int          # tokens seen


class QuantKVCache(NamedTuple):
    """int8 KV cache with a float32 scale per (batch, slot, head)."""
    k: torch.Tensor        # int8 (B, S_max, Hkv, D)
    v: torch.Tensor
    k_scale: torch.Tensor  # float32 (B, S_max, Hkv)
    v_scale: torch.Tensor
    pos: torch.Tensor
    length: int


def _kv_quant(x):
    """x (B,S,H,D) → int8 codes and a per-(B,S,H) float32 scale."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-8)
    q = torch.round(xf / safe[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _kv_dequant(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


#: position of an empty slot: far in the future, so the causal mask hides it
EMPTY_POS = 2**30


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int, dtype,
                  quantized: bool = False, device=None):
    pos = torch.full((s_max,), EMPTY_POS, dtype=torch.int32, device=device)
    shape = (batch, s_max, n_kv, head_dim)
    if quantized:
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], device=device),
            v_scale=torch.zeros(shape[:3], device=device), pos=pos, length=0)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=pos, length=0)


def _write_slots(buf, new, idx: int, s_max: int):
    """``buf[:, idx:idx+s] = new`` in place along axis 1 (cast to buf's
    dtype), with the start
    clamped so the update fits, as ``lax.dynamic_update_slice_in_dim``
    clamps it (no serving step reaches the clamp; a forward over a filled
    cache can)."""
    s = new.shape[1]
    idx = min(max(idx, 0), s_max - s)
    buf[:, idx:idx + s] = new
    return idx


def attention_block(params, cfg, x, *, rope_cs=None, positions=None,
                    window=None, cache=None, backend: str = "chunked"):
    """Attention sub-block: qkv projection → rope → attend → out projection.

    Training / prefill: x is (B, S, D), cache None or an empty cache to
    fill.  Decode: x is (B, 1, D) and cache holds the history.  Returns
    (out, new_cache); the cache's buffers are updated in place.
    """
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin, cfg.rotary_pct)
        k = apply_rope(k, cos, sin, cfg.rotary_pct)

    if cache is None:
        q_pos = k_pos = positions
        k_all, v_all = k, v
        new_cache = None
    else:
        quant = isinstance(cache, QuantKVCache)
        s_max = cache.k.shape[1]
        start = cache.length
        q_pos = start + torch.arange(s, dtype=torch.int32, device=x.device)
        if quant:
            # one scale per (batch, slot, head), so slicing after the
            # quantization equals quantizing the slice
            (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
            fresh = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            fresh = {"k": k, "v": v}
        if s > s_max:
            # Prefill longer than a sliding-window ring: the cache keeps the
            # last s_max entries in order, and attention runs over the whole
            # fresh sequence with k_pos = q_pos.  Slot i then holds position
            # start + s - s_max + i, which is the ring's slot pos % s_max
            # only when s_max divides start + s (JAX's behaviour, kept).
            cache.pos.copy_(q_pos[-s_max:])
            for name, t in fresh.items():
                getattr(cache, name).copy_(t[:, -s_max:])
            k_all, v_all, k_pos = k, v, q_pos
        else:
            # Ring write for decode (JAX: idx = start % s_max when s == 1).
            # A prefill cache is sized to the prompt (launch/serve.py), so
            # the first decode step overwrites slot 0, the oldest prompt
            # token; the JAX package does the same (ROADMAP Queue 3).
            idx = start % s_max if s == 1 else start
            idx = _write_slots(cache.pos[None], q_pos[None], idx, s_max)
            for name, t in fresh.items():
                _write_slots(getattr(cache, name), t, idx, s_max)
            if quant:
                k_all = _kv_dequant(cache.k, cache.k_scale, q.dtype)
                v_all = _kv_dequant(cache.v, cache.v_scale, q.dtype)
            else:
                k_all, v_all = cache.k.to(q.dtype), cache.v.to(q.dtype)
            k_pos = cache.pos
        new_cache = cache._replace(length=start + s)

    softcap = cfg.attn_logit_softcap
    if (s == 1 and cache is not None) or backend == "xla":
        # one-token decode against the whole cache is plain, as in JAX
        out = attention_xla(q, k_all, v_all, q_pos, k_pos, window=window,
                            softcap=softcap)
    elif cfg.scan_unroll:
        raise NotImplementedError(
            "scan_unroll (attention_chunked_unrolled, dry-run costing) waits "
            "for the launch slice of the port (ROADMAP Queue 1)")
    elif backend == "chunked":
        out = ops.attention(q, k_all, v_all, causal=True, window=window,
                            softcap=softcap, q_pos=q_pos, k_pos=k_pos)
    else:
        raise ValueError(f"unknown attention backend {backend!r}")
    out = out.reshape(b, s, cfg.q_dim) @ params["wo"]
    return out, new_cache
