"""Plain PyTorch versions of the port's kernels.

They run on any device.  The CPU tests hold them against the JAX
package's Pallas kernels, word for word; on the card ``chip_smoke.py``
holds each CUDA kernel against them, bit for bit.

Integer work is done in int64 masked with ``0xFFFFFFFF``: PyTorch on the
CPU has no ``>>``, ``<<`` or ``+`` on ``torch.uint32``.  A uint32 tensor is
read through an int32 view and written back the same way, so no uint32
arithmetic or cast kernel is needed on either device.
"""
from __future__ import annotations

import math

import torch

from ..core.compression import PIECE, decode_levels, level_index, wire_index_bits
from .pack_bits import GROUP, LANES, R, _TILE_VALS, _check_bits, n_tiles

_MASK32 = 0xFFFFFFFF


def as_int64(t: torch.Tensor) -> torch.Tensor:
    """Integer tensor (uint32 and uint16 included) as int64 with the same
    values, read through a signed view of the same width."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & _MASK32
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


def to_uint32(t64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as a uint32 tensor."""
    t64 = t64 & _MASK32
    return torch.where(t64 >= 2**31, t64 - 2**32, t64).to(torch.int32).view(
        torch.uint32)


def _quantize_ef(msg, cache, levels, vmin, vmax):
    """Level indices (float32) of msg + cache, formed in float32, and the
    new cache in msg's dtype; with ``cache`` None, the indices of msg alone
    and no new cache."""
    corrected = msg.to(torch.float32)
    if cache is not None:
        corrected = corrected + cache          # a new tensor: msg is never written
    idx = level_index(torch.clamp(corrected, vmin, vmax), levels, vmin, vmax)
    idx = torch.clamp(idx, 0, levels)
    if cache is None:
        return idx, None
    return idx, (corrected - decode_levels(idx, levels, vmin, vmax)).to(msg.dtype)


def quantize_ef_ref(msg, cache, *, levels: int, vmin: float, vmax: float):
    """Fused uplink step (paper Alg. 2 lines 15–16):

        corrected = msg + cache                   (float32)
        wire      = level_index(clip(corrected))  (uint8/uint16)
        new_cache = corrected − decode(wire)      (msg's dtype)

    Returns (wire, new_cache), both in msg's shape; with ``cache`` None,
    (the wire of msg alone, None): the downlink's ``quantize_encode``.
    msg and cache may be of any float dtypes.  It runs a piece of
    :data:`PIECE` values at a time, so the float32 and float64 copies of
    an agent-stacked leaf never exist whole (gemma3-27b's embedding table
    with two agents is 2.8e9 values, 11 GB a float32 copy).
    """
    wire = torch.empty(msg.shape, dtype=wire_dtype(levels), device=msg.device)
    new_cache = None if cache is None else torch.empty(msg.shape, dtype=msg.dtype,
                                                       device=msg.device)
    m = msg.reshape(-1)
    c = None if cache is None else cache.reshape(-1)
    # uint16 through an int16 view: no uint16 cast kernel is needed
    w = wire.view(-1) if levels <= 255 else wire.view(-1).view(torch.int16)
    for s in range(0, m.numel(), PIECE):
        idx, nc = _quantize_ef(m[s:s + PIECE], None if c is None else c[s:s + PIECE],
                               levels, vmin, vmax)
        idx = idx.to(torch.int32)
        w[s:s + PIECE] = idx if levels <= 255 else torch.where(idx >= 2**15, idx - 2**16, idx)
        if nc is not None:
            new_cache.view(-1)[s:s + PIECE] = nc
    return wire, new_cache


def wire_dtype(levels: int) -> torch.dtype:
    """Level-index dtype of :func:`quantize_ef_ref`'s wire: uint8 for
    L ≤ 255, uint16 for L ≤ 65535; larger L has no such wire."""
    if not 1 <= levels <= 65535:
        raise ValueError(f"levels={levels}: the wire is uint8 or uint16")
    return torch.uint8 if levels <= 255 else torch.uint16


def pack_bits_ref(x, bits: int):
    """Plain version of :func:`repro_torch.kernels.pack_bits.pack_bits`.

    Value ``i`` of group ``(r, lane)`` sits at row ``i·R + r`` of a
    (32·R, 128) tile; bit j of value i goes to bit i of word j, and word j
    sits at row ``j·R + r`` of the (b·R, 128) word tile.
    """
    _check_bits(bits)
    n = x.numel()
    tiles = n_tiles(n)
    flat = torch.zeros(tiles * _TILE_VALS, dtype=torch.int64, device=x.device)
    flat[:n] = as_int64(x.reshape(-1)) & _MASK32
    v = flat.reshape(tiles, GROUP, R, LANES)
    shift_i = torch.arange(GROUP, device=x.device).reshape(1, GROUP, 1, 1)
    words = torch.stack([(((v >> j) & 1) << shift_i).sum(dim=1)
                         for j in range(bits)], dim=1)   # (T, b, R, LANES)
    return to_uint32(words.reshape(-1))


def unpack_bits_ref(words, bits: int, n: int):
    """Plain version of :func:`repro_torch.kernels.pack_bits.unpack_bits`."""
    _check_bits(bits)
    tiles = words.numel() // (bits * R * LANES)
    w = as_int64(words).reshape(tiles, bits, 1, R, LANES)
    shift_i = torch.arange(GROUP, device=words.device).reshape(1, GROUP, 1, 1)
    vals = torch.zeros((tiles, GROUP, R, LANES), dtype=torch.int64,
                       device=words.device)
    for j in range(bits):
        vals |= ((w[:, j] >> shift_i) & 1) << j
    return to_uint32(vals.reshape(-1)[:n])


def quant_pipeline_ref(msg, cache, *, levels: int, vmin: float, vmax: float):
    """Plain version of
    :func:`repro_torch.kernels.compress_pipeline.quant_pipeline`:
    quantize+EF, then the transposed bit-plane pack of the indices, so
    ``words == pack_bits_ref(wire)`` and
    ``new_cache == (msg + cache) − decode(wire)``.
    """
    idx, new_cache = _quantize_ef(msg, cache, levels, vmin, vmax)
    words = pack_bits_ref(idx.to(torch.int64), wire_index_bits(levels))
    return words, new_cache


def sign_pipeline_ref(msg, cache):
    """Plain version of
    :func:`repro_torch.kernels.compress_pipeline.sign_pipeline`:

        corrected = msg + cache
        scale     = mean |corrected|            (float32)
        bit       = corrected >= 0              (0 and -0.0 give 1)
        new_cache = corrected − (±scale)
        words     = pack_bits_ref(bit, 1)

    Returns (words, scale, new_cache).
    """
    corrected = msg.to(torch.float32) + cache.to(torch.float32)
    scale = corrected.abs().mean()
    bit = corrected >= 0.0
    decoded = torch.where(bit, scale, -scale)
    new_cache = (corrected - decoded).to(msg.dtype)
    return pack_bits_ref(bit.to(torch.int64), 1), scale, new_cache


_GOLD = 0x9E3779B9          # 2**32/φ: decorrelates consecutive counters


def drop_threshold(p: float) -> int:
    """uint32 threshold: a segment is erased iff its hash < threshold."""
    return min(max(int(round(float(p) * 4294967296.0)), 0), 4294967295)


def _mul32(x, c: int):
    """``x·c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit ``c``.

    The full product can pass 2**63, so ``c`` goes in as two 16-bit
    halves: ``x·c_lo < 2**48`` and ``x·c_hi < 2**48``, and only the low
    16 bits of the high half's product survive the shift by 16.
    """
    hi, lo = c >> 16, c & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(x):
    """murmur3 fmix32 finalizer on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _segment_hash64(idx64, seed: int):
    h = (_mul32(idx64 & _MASK32, _GOLD) + (seed & _MASK32)) & _MASK32
    return _fmix32(_fmix32(h) ^ ((seed >> 32) & _MASK32))


def segment_hash(idx, seed: int):
    """Counter hash of segment indices ``idx`` (any integer tensor, taken
    modulo 2**32) under ``seed``, as a uint32 tensor."""
    return to_uint32(_segment_hash64(as_int64(idx), seed))


def erasure_mask_ref(words, *, p: float, seed: int = 0,
                     segment_words: int = 32):
    """Plain version of :func:`repro_torch.kernels.erasure_mask.erasure_mask`:
    the same counter hash of each word's segment index (flat index taken
    modulo 2**32, as the Pallas kernel's uint32 iota) and the same
    threshold; returns ``(masked, keep)`` uint32 in ``words``' shape."""
    if segment_words < 1:
        raise ValueError(f"segment_words must be >= 1, got {segment_words}")
    flat = as_int64(words.reshape(-1)) & _MASK32
    seg = (torch.arange(flat.numel(), dtype=torch.int64, device=flat.device)
           & _MASK32) // segment_words
    keep = (_segment_hash64(seg, seed) >= drop_threshold(p)).to(torch.int64)
    return (to_uint32(flat * keep).reshape(words.shape),
            to_uint32(keep).reshape(words.shape))


#: score of a masked (query, key) pair: finite, so a row whose first tiles
#: hold only masked keys never computes exp(−inf − (−inf))
NEG_INF = -1e30


def attention_mask(q_pos, k_pos, *, causal: bool, window=None):
    """(Sq, Sk) bool: key j is visible to query i."""
    ok = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


#: log2(e): the kernels keep each row's log-sum-exp in log2 units
LOG2E = 1.4426950408889634


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal: bool = True,
                        window=None, softcap=None, stats: bool = False):
    """Plain version of
    :func:`repro_torch.kernels.flash_attention.flash_attention`.

    q (B, Sq, H, D), k/v (B, Sk, Hkv, D) with H % Hkv == 0; head h reads KV
    head ``h // (H // Hkv)``.  q, k and v are taken to float32 first, as
    the Pallas kernel does (``flash_attention.py:55-56, :73``): scores
    ``q·k/√D`` in float32, ``cap·tanh(s/cap)``, masked pairs set to −1e30,
    softmax, P·V in float32, and the output cast to ``q.dtype`` once.

    With ``stats``, returns ``(out, lse, o)``: what the backward reads
    instead of recomputing, as the bf16 kernel writes it.  ``lse`` (B, H,
    Sq) float32 is each row's log-sum-exp over its visible keys in log2
    units (the natural one times log2(e)), +inf for a row that sees no
    key; ``o`` (B, Sq, H, D) is the output in float32, before its cast.
    """
    n_rep = q.shape[2] // k.shape[2]
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / math.sqrt(q.shape[-1]))
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    ok = attention_mask(q_pos, k_pos, causal=causal, window=window)
    scores.masked_fill_(~ok, NEG_INF)
    lse = None
    if stats:
        lse = torch.logsumexp(scores, dim=-1) * LOG2E
        lse.masked_fill_(~ok.any(dim=-1), math.inf)
    probs = torch.softmax(scores, dim=-1)
    del scores
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    if stats:
        return o.to(q.dtype), lse, o
    return o.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, dout, q_pos, k_pos, *, causal: bool = True,
                            window=None, softcap=None, stats=None):
    """Plain version of
    :func:`repro_torch.kernels.flash_attention.flash_attention_bwd`: the
    gradient of :func:`flash_attention_ref` at ``dout``, written out.

    In float32, with t = q·k/√D, s = cap·tanh(t/cap) (softcap; else s = t)
    and masked pairs at −1e30: the row log-sum-exp as (m, l) with m the
    row maximum and l = Σ exp(s − m), P = exp(s − m)/l, O = P·V and
    D = rowsum(dO∘O); then dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − D) on
    visible pairs (the mask cuts the rest) times the softcap's chain
    factor 1 − tanh²(t/cap), dQ = dS·K/√D and dK = dSᵀ·Q/√D.  dK and dV
    of a KV head sum over its group's heads.  A row that sees no key has
    P = 1/Sk everywhere (the forward's mean of V): it adds dO/Sk to every
    dV and nothing to dQ or dK.  Returns (dq, dk, dv) in the inputs' dtypes.

    ``stats``, the forward's ``(lse, o)`` (:func:`flash_attention_ref` with
    ``stats=True``, or the bf16 kernel's, whose ``lse`` has its rows padded
    past Sq: only the first Sq are read), replaces the recomputed
    statistics, as in the bf16 kernel: P = 2**(s·log2(e) − lse) on visible
    pairs and D from that o.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.to(torch.float32), dout.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    chain = None
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s, chain = th * softcap, 1.0 - th * th
    ok = attention_mask(q_pos, k_pos, causal=causal, window=window)
    if stats is None:
        s = s.masked_fill(~ok, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        p = e / e.sum(dim=-1, keepdim=True)
        del s, e
        o = torch.einsum("bhqk,bkhd->bhqd", p, vf)
        p_dv = p
    else:
        lse, o = stats
        lse = lse[..., :sq].to(torch.float32)
        p = torch.exp2(s * LOG2E - lse[..., None]).masked_fill(~ok, 0.0)
        del s
        o = o.to(torch.float32).transpose(1, 2)
        p_dv = torch.where(ok.any(dim=-1)[:, None], p, 1.0 / sk)
    delta = (dof.transpose(1, 2) * o).sum(dim=-1, keepdim=True)      # (B, H, Sq, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_dv, dof)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    del p, p_dv, o
    ds = ds.masked_fill(~ok, 0.0)
    if chain is not None:
        ds = ds * chain
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    group = lambda t: t.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)
