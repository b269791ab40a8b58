"""Attention: GQA/MQA/MHA with RoPE/M-RoPE, sliding window, KV cache.

Counterpart of ``repro.models.attention``.  Two backends, and the
dry-run's costing path (``cfg.scan_unroll``:
:func:`attention_chunked_unrolled`, plain torch ops, as in JAX):

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

import functools
import math
from typing import NamedTuple, Optional

import torch

from ..device import is_dtensor
from ..kernels import ops
from ..kernels.flash_attention import on_local_heads
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


def _repeat_kv(k, n_rep: int):
    """(B, S, Hkv, D) → (B, S, Hkv·n_rep, D): KV head h // n_rep for head h."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention_chunked_unrolled(q, k, v, q_pos, k_pos, *, window=None,
                               softcap=None, chunk_q: int = 2048,
                               chunk_k: int = 2048):
    """Flash-style attention with a Python loop over (q-chunk, kv-chunk)
    pairs, visiting only causally/within-window reachable pairs: the JAX
    package's ``attention_chunked_unrolled``, op for op, in plain torch.

    The dry-run's costing path (``cfg.scan_unroll``): every chunk's work is
    a dispatched op of its own, so the counts are exact.  Assumes q and k
    positions are aligned ranges (training / prefill), which holds for
    every dry-run shape.  Padded query rows carry position -1, padded keys
    2**30, so the causal mask hides them.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    pad_q, pad_k = (-sq) % chunk_q, (-sk) % chunk_k
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad_k), value=2 ** 30)
    nq, nk = q.shape[1] // chunk_q, k.shape[1] // chunk_k
    out_chunks = []
    for qi in range(nq):
        q_blk = q[:, qi * chunk_q:(qi + 1) * chunk_q]
        qp = q_pos[qi * chunk_q:(qi + 1) * chunk_q]
        acc = torch.zeros((b, h, chunk_q, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, chunk_q), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, chunk_q), dtype=torch.float32, device=q.device)
        # causal: kv chunk start ≤ q chunk end; window: within band
        hi = min(((qi + 1) * chunk_q + chunk_k - 1) // chunk_k, nk)
        lo = 0
        if window is not None:
            lo = max(0, (qi * chunk_q - window) // chunk_k)
        for kj in range(lo, hi):
            k_blk = _repeat_kv(k[:, kj * chunk_k:(kj + 1) * chunk_k], n_rep)
            v_blk = _repeat_kv(v[:, kj * chunk_k:(kj + 1) * chunk_k], n_rep)
            kp = k_pos[kj * chunk_k:(kj + 1) * chunk_k]
            sc = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk).to(torch.float32) * scale
            sc = _softcap(sc, softcap)
            sc = sc.masked_fill(~attention_mask(qp, kp, causal=True, window=window),
                                NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_blk.dtype), v_blk).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        out_chunks.append(out.permute(0, 2, 1, 3))
    out = torch.cat(out_chunks, dim=1)
    return out[:, :sq].to(q.dtype)


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


@functools.lru_cache(maxsize=None)
def _card_127(device: torch.device) -> torch.Tensor:
    """127 as a 0-d tensor on a card, made once per card: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, one ulp off
    the quotient (JAX's and the CPU's) for some dividends."""
    return torch.full((), 127.0, device=device)


def _kv_quant(x):
    """x (B,S,H,D) → int8 codes and a per-(B,S,H) float32 scale."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax / (_card_127(amax.device) if amax.is_cuda else 127.0)
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


def _split_heads(t, n_heads: int, head_dim: int):
    """(B, S, n_heads·head_dim) → (B, S, n_heads, head_dim).  On a DTensor
    whose feature dim has more shards than divide ``n_heads`` (a
    grouped-query projection's few KV heads under tensor parallelism) the
    dim is gathered first: DTensor cannot split a shard across heads."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        from ..launch.sharding import relayout
        last = Shard(t.dim() - 1)
        if n_heads % math.prod(t.device_mesh.size(i)
                               for i, p in enumerate(t.placements) if p == last):
            t = relayout(t, tuple(Replicate() if p == last else p for p in t.placements))
    return t.reshape(*t.shape[:2], n_heads, head_dim)


def attention_block(params, cfg, x, *, rope_cs=None, positions=None,
                    window=None, cache=None, backend: str = "chunked"):
    """Attention sub-block: qkv projection → rope → attend → out projection.

    Training / prefill: x is (B, S, D), cache None or an empty cache to
    fill.  Decode: x is (B, 1, D) and cache holds the history.  Returns
    (out, new_cache); the cache's buffers are updated in place.
    """
    b, s, _ = x.shape
    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.head_dim)

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
    plain = None
    if (s == 1 and cache is not None) or backend == "xla":
        # one-token decode against the whole cache is plain, as in JAX
        plain = attention_xla
    elif cfg.scan_unroll:
        # dry-run costing: the JAX package's loop-free chunk pairs, plain
        plain = attention_chunked_unrolled
    if plain is not None:
        # on DTensors each rank attends its own batch rows and heads
        run = on_local_heads if is_dtensor(q) else (lambda fn, *a: fn(*a))
        out = run(lambda *a: plain(*a, window=window, softcap=softcap),
                  q, k_all, v_all, q_pos, k_pos)
    elif backend == "chunked":
        out = ops.attention(q, k_all, v_all, causal=True, window=window,
                            softcap=softcap, q_pos=q_pos, k_pos=k_pos)
    else:
        raise ValueError(f"unknown attention backend {backend!r}")
    out = out.reshape(b, s, cfg.q_dim) @ params["wo"]
    return out, new_cache
