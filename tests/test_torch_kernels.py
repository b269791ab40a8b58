"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain version (``repro_torch.kernels.ref``);
the JAX kernels run in interpret mode, as the JAX package's own tests run
them.  Inputs are made with numpy from a seed and handed to both.

Tolerance: none.  Words are compared word for word, tile padding
included, and new caches bit for bit.  XLA, compiling the Pallas kernel
for the CPU, multiplies by the float32 reciprocal of Δ and contracts
``x·(1/Δ) + 0.5`` and the decode ``idx·Δ + vmin`` into fused multiply-adds;
the port rounds the same way (``level_index``, ``decode_levels``), so
indices and new caches agree bit for bit.

Attention is float arithmetic summed in another order, so the port's
plain ``flash_attention`` is held within 2e-5 (rtol and atol) of the
Pallas kernel, and the sign scale, a mean, within rtol 1e-6 (its new cache
within atol 1e-6); the sign words are compared word for word.

The CUDA kernels cannot run here; the ``cuda``-marked tests hold them
against the plain versions on a machine with a card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import quantize_decode as jax_quantize_decode
from repro.kernels import compress_pipeline as jcp
from repro.kernels import flash_attention as jfa
from repro.kernels import pack_bits as jpb
from repro.kernels import quantize_ef as jqe
from repro.kernels import ref as jref
from repro_torch.core.compression import decode_levels, wire_index_bits
from repro_torch.kernels import compress_pipeline as tcp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pack_bits as tpb
from repro_torch.kernels import quantize_ef as tqe

PACK_CASES = [(70_001, 1), (70_001, 7), (10_000, 4)]
QUANT_CASES = [(10, -1.0, 1.0), (10, -10.0, 10.0), (255, -1.0, 1.0),
               (1023, -10.0, 10.0)]


def _values(n, bits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32)


def quant_inputs(n, levels, vmin, vmax, seed):
    """msg/cache with exact half-level boundaries, their float neighbours,
    out-of-range values and signed zeros at the front (cache ±0 there)."""
    rng = np.random.default_rng(seed)
    delta = (vmax - vmin) / levels
    half = (vmin + (np.arange(levels) + 0.5) * delta).astype(np.float32)
    special = np.concatenate([
        half, np.nextafter(half, np.float32(np.inf)),
        np.nextafter(half, np.float32(-np.inf)),
        np.array([vmin, vmax, -0.0, 0.0, 3 * vmin, 3 * vmax, vmin - delta,
                  vmax + delta], np.float32)])
    msg = rng.uniform(1.25 * vmin, 1.25 * vmax, n).astype(np.float32)
    cache = rng.uniform(-delta, delta, n).astype(np.float32)
    k = min(n, special.size)
    msg[:k] = special[:k]
    cache[:k] = np.where(np.arange(k) % 2 == 0, np.float32(0.0), np.float32(-0.0))
    return msg, cache


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("n,bits", PACK_CASES)
def test_pack_unpack_match_pallas_word_for_word(n, bits):
    vals = _values(n, bits, seed=bits)
    words_t = ref.pack_bits_ref(torch.from_numpy(vals), bits)
    words_j = np.asarray(jpb.pack_bits(jnp.asarray(vals), bits, interpret=True))
    assert words_t.dtype == torch.uint32
    np.testing.assert_array_equal(_np(words_t), words_j)
    # tile padding packs as zero values
    padded = tpb.n_tiles(n) * tpb.GROUP * tpb.R * tpb.LANES
    assert not _np(ref.unpack_bits_ref(words_t, bits, padded))[n:].any()
    # cross-decode: the port's words in JAX, JAX's words in the port
    np.testing.assert_array_equal(
        np.asarray(jpb.unpack_bits(jnp.asarray(_np(words_t)), bits, n,
                                   interpret=True)), vals)
    np.testing.assert_array_equal(
        _np(ref.unpack_bits_ref(torch.from_numpy(words_j.copy()), bits, n)), vals)


@pytest.mark.parametrize("bits", [17, 31, 32])
def test_pack_full_widths_match_the_layout(bits):
    """Wide words (bit 31 set, b = 32) against the layout written out in
    numpy: bit j of value i of group (r, lane) at bit i of word j."""
    n = 70_001
    vals = _values(n, bits, seed=bits)
    words = _np(ref.pack_bits_ref(torch.from_numpy(vals), bits))
    tiles = tpb.n_tiles(n)
    v = np.zeros(tiles * tpb.GROUP * tpb.R * tpb.LANES, np.uint64)
    v[:n] = vals
    v = v.reshape(tiles, tpb.GROUP, tpb.R, tpb.LANES)
    expect = np.zeros((tiles, bits, tpb.R, tpb.LANES), np.uint64)
    for j in range(bits):
        for i in range(tpb.GROUP):
            expect[:, j] |= ((v[:, i] >> np.uint64(j)) & np.uint64(1)) << np.uint64(i)
    np.testing.assert_array_equal(words, expect.reshape(-1).astype(np.uint32))
    np.testing.assert_array_equal(
        _np(ref.unpack_bits_ref(torch.from_numpy(words), bits, n)), vals)


@pytest.mark.parametrize("levels,vmin,vmax,n",
                         [c + (10_000,) for c in QUANT_CASES]
                         + [(10, -1.0, 1.0, 70_001), (1023, -10.0, 10.0, 70_001)])
def test_quant_pipeline_matches_pallas(levels, vmin, vmax, n):
    msg, cache = quant_inputs(n, levels, vmin, vmax, seed=levels + n)
    words_t, newc_t = ref.quant_pipeline_ref(
        torch.from_numpy(msg), torch.from_numpy(cache), levels=levels,
        vmin=vmin, vmax=vmax)
    words_j, newc_j = jcp.quant_pipeline(jnp.asarray(msg), jnp.asarray(cache),
                                         levels=levels, vmin=vmin, vmax=vmax,
                                         interpret=True)
    np.testing.assert_array_equal(_np(words_t), np.asarray(words_j))
    np.testing.assert_array_equal(_np(newc_t).view(np.int32),
                                  np.asarray(newc_j).view(np.int32))
    # the JAX package's plain reference, compiled, agrees as well
    words_r, newc_r = jax.jit(lambda m, c: jref.quant_pipeline_ref(
        m, c, levels=levels, vmin=vmin, vmax=vmax))(jnp.asarray(msg),
                                                   jnp.asarray(cache))
    np.testing.assert_array_equal(_np(words_t), np.asarray(words_r))
    np.testing.assert_array_equal(_np(newc_t).view(np.int32),
                                  np.asarray(newc_r).view(np.int32))


@pytest.mark.parametrize("levels,vmin,vmax", QUANT_CASES)
def test_quantize_ef_ref_matches_jax(levels, vmin, vmax):
    msg, cache = quant_inputs(5_000, levels, vmin, vmax, seed=7)
    wire_t, newc_t = ref.quantize_ef_ref(torch.from_numpy(msg),
                                         torch.from_numpy(cache), levels=levels,
                                         vmin=vmin, vmax=vmax)
    wire_j, newc_j = jax.jit(lambda m, c: jref.quantize_ef_ref(
        m, c, levels=levels, vmin=vmin, vmax=vmax))(jnp.asarray(msg),
                                                   jnp.asarray(cache))
    assert str(wire_t.dtype).split(".")[-1] == str(wire_j.dtype)
    np.testing.assert_array_equal(_np(wire_t), np.asarray(wire_j))
    np.testing.assert_array_equal(_np(newc_t).view(np.int32),
                                  np.asarray(newc_j).view(np.int32))


QEF_CASES = [(10, -1.0, 1.0), (10, -0.25, 0.25), (255, -1.0, 1.0),
             (255, -0.25, 0.25), (1023, -1.0, 1.0), (1023, -0.25, 0.25)]


@pytest.mark.parametrize("levels,vmin,vmax", QEF_CASES)
def test_quantize_ef_matches_pallas(levels, vmin, vmax):
    """The port's quantize_ef (plain version on the CPU) against the Pallas
    kernel, compiled by ``jax.jit`` in interpret mode: uint8 wire for
    L ≤ 255, uint16 above, bit for bit with the new cache."""
    msg, cache = quant_inputs(70_001, levels, vmin, vmax, seed=levels + 5)
    wire_t, newc_t = ops.quantize_ef(torch.from_numpy(msg), torch.from_numpy(cache),
                                     levels=levels, vmin=vmin, vmax=vmax)
    wire_j, newc_j = jqe.quantize_ef(jnp.asarray(msg), jnp.asarray(cache),
                                     levels=levels, vmin=vmin, vmax=vmax,
                                     interpret=True)
    assert wire_t.dtype == (torch.uint8 if levels <= 255 else torch.uint16)
    assert str(wire_t.dtype).split(".")[-1] == str(wire_j.dtype)
    np.testing.assert_array_equal(_np(wire_t), np.asarray(wire_j))
    np.testing.assert_array_equal(_np(newc_t).view(np.int32),
                                  np.asarray(newc_j).view(np.int32))
    assert wire_t.shape == newc_t.shape == (70_001,)


@pytest.mark.parametrize("levels,vmin,vmax", QEF_CASES)
def test_quantize_ef_is_unpacked_quant_pipeline(levels, vmin, vmax):
    """unpack_bits(quant_pipeline(m, c)) is quantize_ef(m, c)'s wire, and the
    two new caches are bit-equal (2-D, as a cohort's stacked uplink)."""
    msg, cache = (torch.from_numpy(a).reshape(7, -1) for a in
                  quant_inputs(7 * 2_048, levels, vmin, vmax, seed=levels))
    wire, newc = ops.quantize_ef(msg, cache, levels=levels, vmin=vmin, vmax=vmax)
    words, newc_p = ops.quant_pipeline(msg, cache, levels=levels, vmin=vmin,
                                       vmax=vmax)
    idx = ops.unpack_bits(words, wire_index_bits(levels), msg.numel())
    np.testing.assert_array_equal(_np(idx).reshape(7, -1), _np(wire).astype(np.uint32))
    np.testing.assert_array_equal(_np(newc).view(np.int32), _np(newc_p).view(np.int32))
    assert wire.shape == (7, 2_048)


def test_quantize_ef_checks():
    with pytest.raises(TypeError):
        tqe.quantize_ef(torch.zeros(4, dtype=torch.float64, device="meta"),
                        torch.zeros(4, dtype=torch.float64, device="meta"))
    assert ref.wire_dtype(255) == torch.uint8 and ref.wire_dtype(256) == torch.uint16


@pytest.mark.parametrize("levels,vmin,vmax", QUANT_CASES + [(1000, -10.0, 10.0)])
def test_decode_levels_rounds_once_like_compiled_jax(levels, vmin, vmax):
    idx = np.arange(levels + 1, dtype=np.uint32)
    ours = _np(decode_levels(torch.from_numpy(idx.astype(np.int64)), levels,
                             vmin, vmax))
    theirs = np.asarray(jax.jit(lambda i: jax_quantize_decode(
        i, levels, vmin, vmax))(jnp.asarray(idx)))
    np.testing.assert_array_equal(ours.view(np.int32), theirs.view(np.int32))
    # and it is the fused multiply-add, not a product rounded then a sum
    fma = (idx.astype(np.float64) * np.float64(np.float32((vmax - vmin) / levels))
           + np.float64(np.float32(vmin))).astype(np.float32)
    np.testing.assert_array_equal(ours.view(np.int32), fma.view(np.int32))


def test_cpu_dispatch_takes_the_plain_version_and_counts_no_launch():
    vals = torch.from_numpy(_values(1_000, 4, seed=1))
    before = ops.launch_counts()
    words = ops.pack_bits(vals, 4)
    np.testing.assert_array_equal(_np(words), _np(ref.pack_bits_ref(vals, 4)))
    np.testing.assert_array_equal(_np(ops.unpack_bits(words, 4, 1_000)), _np(vals))
    msg, cache = (torch.from_numpy(a) for a in quant_inputs(1_000, 10, -1.0, 1.0, 2))
    w, c = ops.quant_pipeline(msg, cache, levels=10, vmin=-1.0, vmax=1.0)
    w_r, c_r = ref.quant_pipeline_ref(msg, cache, levels=10, vmin=-1.0, vmax=1.0)
    assert torch.equal(w.view(torch.int32), w_r.view(torch.int32))
    assert torch.equal(c.view(torch.int32), c_r.view(torch.int32))
    assert ops.launch_counts() == before


def test_layout_constants_and_checks():
    assert (tpb.LANES, tpb.GROUP, tpb.R) == (jpb.LANES, jpb.GROUP, jpb.R)
    for n, b in [(0, 1), (1, 32), (100, 4), (10_000, 4), (70_001, 13)]:
        assert tpb.logical_words(n, b) == jpb.logical_words(n, b)
    assert tpb.n_tiles(0) == 1 and tpb.n_tiles(32_769) == 2
    for bad in (0, 33):
        with pytest.raises(ValueError):
            tpb.pack_bits(torch.zeros(4, dtype=torch.int64), bad)
    with pytest.raises(ValueError, match="whole number"):
        tpb.unpack_bits(torch.zeros(100, dtype=torch.uint32), 4, 10)
    with pytest.raises(ValueError, match="cannot unpack"):
        tpb.unpack_bits(torch.zeros(4 * 1024, dtype=torch.uint32), 4, 40_000)
    assert wire_index_bits(10) == 4


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    from repro_torch.kernels.compress_pipeline import quant_pipeline
    for n, bits in PACK_CASES:
        vals = torch.from_numpy(_values(n, bits, seed=bits)).cuda()
        words = tpb.pack_bits(vals, bits)
        assert torch.equal(words.view(torch.int32),
                           ref.pack_bits_ref(vals, bits).view(torch.int32))
        assert torch.equal(tpb.unpack_bits(words, bits, n).view(torch.int32),
                           vals.view(torch.int32))
    for levels, vmin, vmax in QUANT_CASES:
        msg, cache = (torch.from_numpy(a).cuda()
                      for a in quant_inputs(70_001, levels, vmin, vmax, 3))
        w, c = quant_pipeline(msg, cache, levels=levels, vmin=vmin, vmax=vmax)
        w_r, c_r = ref.quant_pipeline_ref(msg, cache, levels=levels, vmin=vmin,
                                          vmax=vmax)
        assert torch.equal(w.view(torch.int32), w_r.view(torch.int32))
        assert torch.equal(c.view(torch.int32), c_r.view(torch.int32))


@pytest.mark.cuda
def test_cuda_quantize_ef_matches_plain():
    """The CUDA quantize_ef against its plain version on the card: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for levels, vmin, vmax in QEF_CASES:
        msg, cache = (torch.from_numpy(a).cuda()
                      for a in quant_inputs(70_001, levels, vmin, vmax, 3))
        w, c = tqe.quantize_ef(msg, cache, levels=levels, vmin=vmin, vmax=vmax)
        w_r, c_r = ref.quantize_ef_ref(msg, cache, levels=levels, vmin=vmin,
                                       vmax=vmax)
        as_signed = lambda t: t.view(torch.int16) if t.dtype == torch.uint16 else t
        assert w.dtype == w_r.dtype and torch.equal(as_signed(w), as_signed(w_r))
        assert torch.equal(c.view(torch.int32), c_r.view(torch.int32))


# -- sign_pipeline ------------------------------------------------------------

def sign_inputs(n, seed):
    """msg/cache with exact zeros and signed zeros at the front (cache ±0
    there, so msg + cache keeps them) and values that cancel to 0."""
    rng = np.random.default_rng(seed)
    msg = rng.standard_normal(n).astype(np.float32)
    cache = (0.1 * rng.standard_normal(n)).astype(np.float32)
    special = np.array([0.0, -0.0, 0.0, -0.0, 1.5, -1.5], np.float32)
    k = min(n, special.size)
    msg[:k] = special[:k]
    cache[:k] = np.array([0.0, 0.0, -0.0, -0.0, -1.5, 1.5], np.float32)[:k]
    return msg, cache


@pytest.mark.parametrize("n", [100, 70_001])
def test_sign_pipeline_matches_pallas(n):
    msg, cache = sign_inputs(n, seed=n)
    words_t, scale_t, newc_t = ops.sign_pipeline(torch.from_numpy(msg),
                                                 torch.from_numpy(cache))
    words_j, scale_j, newc_j = jcp.sign_pipeline(jnp.asarray(msg), jnp.asarray(cache),
                                                 interpret=True)
    assert words_t.dtype == torch.uint32 and words_t.shape == (tpb.n_tiles(n) * 1024,)
    np.testing.assert_array_equal(_np(words_t), np.asarray(words_j))
    assert scale_t.dtype == torch.float32 and scale_t.dim() == 0
    np.testing.assert_allclose(float(scale_t), float(scale_j), rtol=1e-6)
    np.testing.assert_allclose(_np(newc_t), np.asarray(newc_j), rtol=0, atol=1e-6)
    # bit 1 for 0 and -0.0, and the words decode to the signs
    bits = _np(ref.unpack_bits_ref(words_t, 1, n))
    np.testing.assert_array_equal(bits, (msg + cache >= 0).astype(np.uint32))
    assert bits[:4].all()


@pytest.mark.parametrize("n", [100, 70_001])
def test_sign_pipeline_bf16_matches_pallas(n):
    """bf16 msg and cache, as a bf16 model's uplink hands them over: the
    port and the Pallas kernel both compute in float32 and write the new
    cache in bf16.  Words equal, scale within rtol 1e-6, and each new cache
    bit for bit bf16(corrected ∓ its own scale), so the two are equal but
    where the two float32 means (torch's and XLA's orders) round a value to
    neighbouring bf16s."""
    msg, cache = sign_inputs(n, seed=n + 2)
    mj, cj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (msg, cache))
    mt, ct = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (mj, cj))
    words_t, scale_t, newc_t = ops.sign_pipeline(mt, ct)
    words_j, scale_j, newc_j = jcp.sign_pipeline(mj, cj, interpret=True)
    assert newc_t.dtype == torch.bfloat16 and newc_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(words_t), np.asarray(words_j))
    assert scale_t.dtype == torch.float32
    np.testing.assert_allclose(float(scale_t), float(scale_j), rtol=1e-6)
    cor = mt.float() + ct.float()
    for got, scale in ((newc_t, scale_t), (torch.from_numpy(
            np.asarray(newc_j.astype(jnp.float32))).to(torch.bfloat16),
            torch.tensor(float(scale_j)))):
        want = (cor - torch.where(cor >= 0, scale, -scale)).to(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_sign_pipeline_2d_and_checks():
    msg, cache = (torch.from_numpy(a).reshape(7, -1) for a in sign_inputs(7 * 300, 3))
    words, scale, newc = ops.sign_pipeline(msg, cache)
    w_r, s_r, c_r = ref.sign_pipeline_ref(msg.reshape(-1), cache.reshape(-1))
    assert newc.shape == (7, 300)
    assert torch.equal(words.view(torch.int32), w_r.view(torch.int32))
    assert torch.equal(newc.reshape(-1), c_r) and torch.equal(scale, s_r)
    with pytest.raises(TypeError):
        tcp.sign_pipeline(torch.zeros(4, dtype=torch.float64, device="meta"),
                          torch.zeros(4, dtype=torch.float64, device="meta"))
    with pytest.raises(TypeError):          # one dtype for msg and cache
        tcp.sign_pipeline(torch.zeros(4, dtype=torch.bfloat16, device="meta"),
                          torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        tcp.sign_pipeline(torch.zeros(4, device="meta"), torch.zeros(5, device="meta"))


# -- flash_attention ----------------------------------------------------------

FLASH_CASES = [(s, d, w, c) for s in (128, 257) for d in (64, 120)
               for w, c in ((None, None), (64, 30.0))]


@pytest.mark.parametrize("s,d,window,softcap", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(s, d, window, softcap):
    """The port's plain version against the Pallas kernel (interpret mode,
    equal heads: it takes GQA expanded by the caller), within 2e-5."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.standard_normal((2, s, 3, d)).astype(np.float32) for _ in range(3))
    theirs = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=True, window=window, softcap=softcap,
                                 interpret=True)
    ours = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window, softcap=softcap)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), rtol=2e-5, atol=2e-5)


def test_flash_attention_gqa_reads_kv_head_h_over_n_rep():
    """Head h reads KV head h // (H // Hkv): the same as the Pallas kernel
    on K/V expanded by the JAX model's _repeat_kv."""
    from repro.models.attention import _repeat_kv
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 130, 8, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 130, 2, 64)).astype(np.float32) for _ in range(2))
    theirs = jfa.flash_attention(jnp.asarray(q), _repeat_kv(jnp.asarray(k), 4),
                                 _repeat_kv(jnp.asarray(v), 4), window=50,
                                 interpret=True)
    ours = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         window=50)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), rtol=2e-5, atol=2e-5)


def test_flash_attention_non_causal_and_checks():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2, 16)).astype(np.float32))
               for _ in range(3))
    ours = tfa.flash_attention(q, k, v, causal=False)
    full = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0, dim=-1)
    np.testing.assert_allclose(_np(ours), _np(torch.einsum("bhqk,bkhd->bqhd", full, v)),
                               rtol=2e-5, atol=2e-5)
    meta = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device="meta")
    with pytest.raises(TypeError):
        tfa.flash_attention(meta(1, 8, 2, 16, dt=torch.float16),
                            meta(1, 8, 2, 16, dt=torch.float16),
                            meta(1, 8, 2, 16, dt=torch.float16))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(meta(1, 8, 2, 160), meta(1, 8, 2, 160), meta(1, 8, 2, 160))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(meta(1, 8, 3, 16), meta(1, 8, 2, 16), meta(1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="positions"):
        tfa.flash_attention(q, k, v, q_pos=torch.arange(3))


def test_cpu_dispatch_of_the_new_kernels_counts_no_launch():
    before = ops.launch_counts()
    assert before.keys() >= {"sign_pipeline", "flash_attention"}
    msg, cache = (torch.from_numpy(a) for a in sign_inputs(1_000, 4))
    ops.sign_pipeline(msg, cache)
    q = torch.zeros(1, 8, 2, 16)
    ops.attention(q, q, q)
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_cuda_sign_pipeline_matches_plain():
    """The CUDA sign_pipeline against its plain version on the card: words
    word for word, the scale (reduced inside the launch, the plain version
    reduces with torch) within rtol 1e-6 and bit for bit the numpy model's
    fixed-order sum, the new cache within atol 1e-6 and bit for bit
    msg + cache ∓ the model's scale; at 100, 70,001, 1 and
    32,769 values, on a msg and cache view off 16 bytes (the 4-byte load
    path), and two calls bit for bit the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for n, offset in ((100, 0), (70_001, 0), (1, 0), (32_769, 0), (70_001, 1)):
        m_np, c_np = sign_inputs(n, n)
        msg, cache = (torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), a]))
                      .cuda()[offset:] for a in (m_np, c_np))
        assert (msg.data_ptr() % 16 == 0) == (offset == 0)
        w, s, c = tcp.sign_pipeline(msg, cache)
        w_r, s_r, c_r = ref.sign_pipeline_ref(msg, cache)
        assert torch.equal(w.view(torch.int32), w_r.view(torch.int32))
        assert abs(float(s) - float(s_r)) <= 1e-6 * abs(float(s_r))
        s_model = _sign_model_scale(m_np, c_np)
        assert np.float32(s.item()).tobytes() == s_model.tobytes()
        assert float((c - c_r).abs().max()) <= 1e-6
        cor = np.add(m_np, c_np, dtype=np.float32)
        want = cor - np.where(cor >= 0, s_model, -s_model).astype(np.float32)
        np.testing.assert_array_equal(c.cpu().numpy().view(np.int32), want.view(np.int32))
        w2, s2, c2 = tcp.sign_pipeline(msg, cache)
        assert torch.equal(w2.view(torch.int32), w.view(torch.int32))
        assert torch.equal(s2.view(torch.int32), s.view(torch.int32))
        assert torch.equal(c2.view(torch.int32), c.view(torch.int32))


@pytest.mark.cuda
def test_cuda_sign_pipeline_bf16_matches_plain():
    """The CUDA sign_pipeline on bf16 msg and cache against its plain
    version on the card: words word for word, the scale within rtol 1e-6
    and bit for bit the numpy model's fixed-order sum of the float32
    values, the bf16 new cache bit for bit bf16(msg + cache ∓ that scale)
    and within one bf16 rounding of the plain version's; at 100, 70,001
    and 2**24 values and on views 2 bytes off 8 (value by value), two calls
    bit for bit the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for n, offset in ((100, 0), (70_001, 0), (2**24, 0), (70_001, 1)):
        m_np, c_np = sign_inputs(n, n + 3)
        msg, cache = (torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), a]))
                      .cuda().to(torch.bfloat16)[offset:] for a in (m_np, c_np))
        assert (msg.data_ptr() % 8 == 0) == (offset == 0)
        w, s, c = tcp.sign_pipeline(msg, cache)
        w_r, s_r, c_r = ref.sign_pipeline_ref(msg, cache)
        assert c.dtype == torch.bfloat16
        assert torch.equal(w.view(torch.int32), w_r.view(torch.int32))
        assert abs(float(s) - float(s_r)) <= 1e-6 * abs(float(s_r))
        mf, cf = (t.float().cpu().numpy() for t in (msg, cache))
        s_model = _sign_model_scale(mf, cf)
        assert np.float32(s.item()).tobytes() == s_model.tobytes()
        cor = msg.float() + cache.float()
        want = (cor - torch.where(cor >= 0, s, -s)).to(torch.bfloat16)
        assert torch.equal(c.view(torch.int16), want.view(torch.int16))
        assert bool(((c.float() - c_r.float()).abs()
                     <= 1e-6 + 2**-7 * c_r.float().abs()).all())
        w2, s2, c2 = tcp.sign_pipeline(msg, cache)
        assert torch.equal(w2.view(torch.int32), w.view(torch.int32))
        assert torch.equal(s2.view(torch.int32), s.view(torch.int32))
        assert torch.equal(c2.view(torch.int16), c.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 2**-7, 1e-4)])
def test_cuda_flash_attention_matches_plain(dtype, rtol, atol):
    """The CUDA flash_attention against its plain version on the card, GQA,
    window, softcap and a query range after its keys: float32 within 2e-5
    on the float32 route's kernel, bf16 within one output rounding
    (2**-7·|plain| + 1e-4) on the sm90 kernel; the launch counts show the
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    name = tfa.route(dtype, "cuda")
    for s, d, window, softcap in FLASH_CASES:
        q, k, v = (torch.randn((2, s, h, d), generator=gen, device="cuda").to(dtype)
                   for h in (8, 2, 2))
        qp = torch.arange(s, device="cuda") + 7
        before = ops.launch_counts()
        out = tfa.flash_attention(q[:, s // 2:], k, v, qp[s // 2:], qp,
                                  window=window, softcap=softcap)
        after = ops.launch_counts()
        assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {name: 1}
        plain = ref.flash_attention_ref(q[:, s // 2:], k, v, qp[s // 2:].int(),
                                        qp.int(), window=window, softcap=softcap)
        torch.testing.assert_close(out.float(), plain.float(), rtol=rtol, atol=atol)


# -- flash_attention's bf16 route (csrc/flash_attention_sm90.cu) -------------

@pytest.mark.parametrize("dtype,device,expect", [
    (torch.float32, "cpu", "plain"), (torch.bfloat16, "cpu", "plain"),
    (torch.float32, "cuda", "flash_attention"),
    (torch.bfloat16, "cuda", "flash_attention_sm90"),
    (torch.float16, "cuda", TypeError)])
def test_flash_attention_route(dtype, device, expect):
    """CPU tensors take the plain version, float32 on the card the float32
    kernel, bf16 the sm90 kernel; each kernel has its own launch count."""
    if expect is TypeError:
        with pytest.raises(TypeError):
            tfa.route(dtype, device)
        return
    assert tfa.route(dtype, device) == expect
    if expect != "plain":
        assert expect in ops.launch_counts()


def _ring_positions(s_max, end, empty, seed):
    """A ring cache's pos: positions end - s_max .. end - 1 at slot
    pos % s_max, with ``empty`` random slots at 2**30 (never written)."""
    pos = np.arange(end - s_max, end)
    ring = np.empty(s_max, np.int64)
    ring[pos % s_max] = pos
    ring[np.random.default_rng(seed).choice(s_max, empty, replace=False)] = 2**30
    return ring


# (name, q_pos, k_pos, causal, window, consecutive positions)
PLAN_CASES = [
    ("aligned", np.arange(300), np.arange(300), True, None, True),
    ("aligned-window", np.arange(1000), np.arange(1000), True, 200, True),
    ("window-4096", np.arange(8192), np.arange(8192), True, 4096, True),
    ("offset", np.arange(200, 300) + 100, np.arange(300) + 100, True, 64, True),
    ("ragged", np.arange(128, 257), np.arange(257), True, 64, True),
    ("ring", 900 + np.arange(200), _ring_positions(512, 1100, 9, 0), True, 300, False),
    ("ring-causal", 1000 + np.arange(100), _ring_positions(384, 1100, 5, 1), True, None,
     False),
    ("non-causal-window", np.arange(400), np.arange(400), False, 100, True),
    ("shuffled", np.arange(300), np.random.default_rng(2).permutation(300), True, 50,
     False),
    ("keys-ahead", np.arange(385), np.arange(192, 577), True, None, True),
]


def _check_plan(name, q_pos, k_pos, causal, window, consecutive, bk):
    qp, kp = torch.from_numpy(q_pos).int(), torch.from_numpy(k_pos).int()
    plan = tfa.tile_plan(qp, kp, causal=causal, window=window, block_k=bk)
    mask = ref.attention_mask(qp, kp, causal=causal, window=window)
    bq = tfa.BLOCK_Q
    assert plan.shape == (-(-len(q_pos) // bq), -(-len(k_pos) // bk))
    assert plan.dtype == torch.int8
    for qt in range(plan.shape[0]):
        for kt in range(plan.shape[1]):
            block = mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
            kind = int(plan[qt, kt])
            assert kind in (tfa.SKIP, tfa.MASKED, tfa.FULL)
            if kind == tfa.SKIP:
                assert not block.any(), (name, qt, kt)
            if kind == tfa.FULL:
                assert block.all() and block.shape[1] == bk, (name, qt, kt)
            if consecutive:
                assert (kind != tfa.SKIP) == bool(block.any()), (name, qt, kt)
                assert (kind == tfa.FULL) == (bool(block.all()) and block.shape[1] == bk)
    return plan


@pytest.mark.parametrize("name,q_pos,k_pos,causal,window,consecutive", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_tile_plan_against_the_dense_mask(name, q_pos, k_pos, causal, window,
                                          consecutive):
    """No visible pair ever lies in a skipped tile, every pair of a FULL
    tile is visible and its keys lie inside Sk; for consecutive positions
    the plan is exact (a tile is visited iff it holds a visible pair)."""
    plan = _check_plan(name, q_pos, k_pos, causal, window, consecutive, tfa.BLOCK_K)
    if name == "window-4096":    # the serving shape: 1584 of 4096 tiles, 96 masked
        assert int((plan != tfa.SKIP).sum()) == 1584
        assert int((plan == tfa.MASKED).sum()) == 96


@pytest.mark.parametrize("name,q_pos,k_pos,causal,window,consecutive", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_f32_tile_plan_against_the_dense_mask(name, q_pos, k_pos, causal, window,
                                              consecutive):
    """The same rule at the float32 kernel's tiles (128 query rows, 64
    keys), which csrc/flash_attention.cu applies in each block."""
    plan = _check_plan(name, q_pos, k_pos, causal, window, consecutive,
                       tfa.F32_BLOCK_K)
    assert tfa.F32_BLOCK_Q == tfa.BLOCK_Q
    if name == "window-4096":    # the serving shape: 3168 of 8192 tiles, 192 masked
        assert int((plan != tfa.SKIP).sum()) == 3168
        assert int((plan == tfa.MASKED).sum()) == 192


@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_row_without_keys_is_the_mean_of_v(window):
    """A row that sees no key has every score at the sentinel, so its
    softmax is uniform over the Sk keys and its output is the mean of V:
    the answer both kernels compute for such rows."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 385, 4, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 385, 2, 16), np.float32))
            for _ in range(2))
    out = tfa.flash_attention(q, k, v, torch.arange(385), torch.arange(192, 577),
                              causal=True, window=window)
    mean = v.mean(dim=1).repeat_interleave(2, dim=1)          # (1, H, D)
    torch.testing.assert_close(out[:, :192], mean[:, None].expand(1, 192, 4, 16),
                               rtol=1e-5, atol=1e-6)
    assert not torch.allclose(out[:, 192:], mean[:, None].expand(1, 193, 4, 16))


def test_tma_layout_copies_only_what_tma_cannot_read():
    """An aligned (B, S, H, D) view is read in place; a base off by one
    element, or D not a multiple of 8, is copied (D zero-padded); the
    stride of a size-1 dimension is given as the contiguous one."""
    base = torch.zeros(2, 300, 4, 120, dtype=torch.bfloat16)
    view = base[:, 100:]                       # sliced start: still aligned
    t, st = tfa.tma_layout(view)
    assert t.data_ptr() == view.data_ptr() and st == view.stride()[:3]
    flat = torch.zeros(1 + 300 * 4 * 120, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 300, 4, 120)        # base 2 bytes off 16
    t, st = tfa.tma_layout(odd)
    assert t.data_ptr() != odd.data_ptr() and t.data_ptr() % 16 == 0
    assert torch.equal(t, odd) and st == (300 * 4 * 120, 480, 120)
    x = torch.randn(1, 10, 2, 100).to(torch.bfloat16)
    t, st = tfa.tma_layout(x)
    assert t.shape == (1, 10, 2, 104) and st == (10 * 2 * 104, 208, 104)
    assert torch.equal(t[..., :100], x) and not t[..., 100:].any()
    wide = torch.zeros(1, 10, 16, 64, dtype=torch.bfloat16)[:, :, 3:4]   # H = 1
    t, st = tfa.tma_layout(wide)
    assert t.data_ptr() == wide.data_ptr() and st == (10 * 64, 16 * 64, 64)   # B = 1 too


def _emulate_sm90(q, k, v, q_pos, k_pos, *, window, softcap, split: bool):
    """The sm90 kernel's arithmetic, in torch on the CPU: scores in float32,
    the online softmax over key tiles of BLOCK_K in increasing order, then
    P·V against bf16 V with P in bf16 as P_hi + P_lo (``split``) or rounded
    once, products exact and sums in float32; the output cast to bf16 once.
    (A skipped tile only ever precedes a row's first visible key, whose
    rescale by exp(−1e30 − m) = 0 wipes it, so visiting it changes nothing.)"""
    n_rep = q.shape[2] // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / math.sqrt(q.shape[-1]))
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~ref.attention_mask(q_pos, k_pos, causal=True, window=window),
                      ref.NEG_INF)
    b, h, sq, sk = s.shape
    m = torch.full((b, h, sq, 1), ref.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, q.shape[-1]))
    vh = vf.permute(0, 2, 1, 3)                  # (b, h, sk, d)
    for k0 in range(0, sk, tfa.BLOCK_K):
        st = s[..., k0:k0 + tfa.BLOCK_K]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vh[:, :, k0:k0 + tfa.BLOCK_K]
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + lo @ vh[:, :, k0:k0 + tfa.BLOCK_K]
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3).to(torch.bfloat16)


def _within_one_rounding(out, plain) -> bool:
    out, plain = out.float(), plain.float()
    return bool(((out - plain).abs() <= 1e-4 + 2**-7 * plain.abs()).all())


@pytest.mark.parametrize("s,d,h,hkv", [(s, d, h, hkv) for s in (128, 257)
                                       for d in (64, 120, 128)
                                       for h, hkv in ((4, 4), (32, 8))])
def test_split_p_keeps_pv_at_float32_accuracy(s, d, h, hkv):
    """Over chip_smoke.py's bf16 grid at S <= 257 (window x softcap x
    offset), the kernel's P·V arithmetic with P = P_hi + P_lo stays within
    one bf16 rounding of the plain version, 2**-7·|plain| + 1e-4; with P
    rounded once to bf16 (as FA3 and cuDNN round it) no case does."""
    rng = np.random.default_rng(s * 1000 + d + h)
    for window in (None, 64, 4096):
        for softcap in (None, 30.0):
            for offset in (False, True):
                sq = (s + 2) // 3 if offset else s
                q = torch.from_numpy(rng.standard_normal((2, sq, h, d), np.float32))
                k, v = (torch.from_numpy(rng.standard_normal((2, s, hkv, d), np.float32))
                        for _ in range(2))
                q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
                k_pos = torch.arange(s, dtype=torch.int32) + (100 if offset else 0)
                q_pos = k_pos[s - sq:]
                kw = dict(window=window, softcap=softcap)
                plain = ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=True, **kw)
                case = (window, softcap, offset)
                assert _within_one_rounding(
                    _emulate_sm90(q, k, v, q_pos, k_pos, split=True, **kw), plain), case
                assert not _within_one_rounding(
                    _emulate_sm90(q, k, v, q_pos, k_pos, split=False, **kw), plain), case


# -- flash_attention's float32 route (csrc/flash_attention.cu) ---------------

def test_f32_geometry_fits_shared_memory_at_every_head_dim():
    """The float32 kernel's Q tile, two-stage K/V ring and plan fit the
    227 KB a block may use at every D <= 128; K and P^T rows are padded to
    8 mod 32 floats and hold D columns and the 128 query rows."""
    sizes = {d: tfa.f32_smem_bytes(d) for d in range(1, tfa.MAX_HEAD_DIM + 1)}
    assert max(sizes.values()) == sizes[tfa.MAX_HEAD_DIM] <= tfa.SMEM_LIMIT == 232_448
    assert tfa.F32_K_STRIDE % 32 == 8
    assert tfa.F32_K_STRIDE >= max(tfa.F32_BLOCK_Q, tfa.MAX_HEAD_DIM)
    kv = 4 * tfa.F32_STAGES * tfa.F32_BLOCK_K * (tfa.F32_K_STRIDE + 128)
    assert sizes[120] == 4 * 128 * 120 + kv + tfa.F32_PLAN_TILES == 198_656
    assert sizes[64] == 4 * 128 * 64 + kv - 4 * 2 * 64 * 64 + tfa.F32_PLAN_TILES
    assert all(sizes[d] == sizes[-(-d // 8) * 8] for d in sizes)    # D rounds up to 8


def test_vec_ready_decides_the_float32_copy_width():
    """16-byte copies need a 16-byte aligned base, D a multiple of 4 and
    the strides of dimensions of size > 1 multiples of 4; anything else is
    read with 4-byte copies, never copied on the host."""
    base = torch.zeros(2, 300, 4, 120)
    assert tfa.vec_ready(base) and tfa.vec_ready(base[:, 100:])
    flat = torch.zeros(1 + base.numel())
    assert not tfa.vec_ready(flat[1:].view(base.shape))              # base 4 bytes off
    assert not tfa.vec_ready(torch.zeros(1, 10, 2, 33))               # D = 33
    wide = torch.zeros(1, 10, 82)[:, :, :80].unflatten(-1, (2, 40))   # S stride 82
    assert not tfa.vec_ready(wide)
    ones = torch.empty_strided((1, 10, 1, 40), (3, 40, 5, 1))         # B = H = 1
    assert tfa.vec_ready(ones)


# -- unpack_bits (csrc/pack_bits.cu) -----------------------------------------

UNPACK_MODEL_N = [1, 31, 32, 10_000, 32_768, 32_769, 70_001]


@pytest.mark.parametrize("bits", [1, 4, 8, 32])
@pytest.mark.parametrize("n", UNPACK_MODEL_N)
def test_unpack_thread_map_writes_each_value_once(n, bits):
    """A numpy model of unpack_bits_kernel's map: block = tile, thread t =
    columns 4t .. 4t + 3, and row i of them = values (tile·32 + i)·1024 +
    4t .. + 3.  Every index < n is written exactly once and none >= n; a
    group of four inside n is one 16-byte store (aligned, as vals comes
    from torch.empty), the one group that crosses n is stored value by
    value; each word plane is one 16-byte load exactly when the word
    buffer's base is 16-byte aligned.  The values the model reads are the
    plain version's."""
    T, C, cols = tpb.UNPACK_THREADS, tpb.UNPACK_COLS, tpb.R * tpb.LANES
    assert T * C == cols                         # a block covers a tile's columns
    tiles = tpb.n_tiles(n)
    tile, thread, row = np.meshgrid(np.arange(tiles), np.arange(T), np.arange(tpb.GROUP),
                                    indexing="ij")
    first = (tile * tpb.GROUP + row) * cols + C * thread      # a group's first value
    vec = first + C <= n
    cross = (first < n) & ~vec
    assert int(vec.sum()) == n // C and int(cross.sum()) == int(n % C > 0)
    assert (first[vec] % C == 0).all()
    stored = np.concatenate([(first[vec][:, None] + np.arange(C)).ravel(),
                             [i for f in first[cross] for i in range(f, n)]])
    assert stored.max() < n
    np.testing.assert_array_equal(np.bincount(stored.astype(np.int64), minlength=n),
                                  np.ones(n, np.int64))
    # loads: plane j of a thread's columns at word (tile·bits + j)·1024 + 4t
    words = ref.pack_bits_ref(torch.from_numpy(_values(n, bits, seed=n + bits)), bits)
    w = _np(words).reshape(tiles, bits, cols).astype(np.uint64)
    lanes = (C * np.arange(T))[:, None] + np.arange(C)               # (T, C)
    planes = w[:, :, lanes]                                          # (tiles, bits, T, C)
    i = np.arange(tpb.GROUP, dtype=np.uint64)
    j = np.arange(bits, dtype=np.uint64)
    vals = (((planes[:, None] >> i[None, :, None, None, None]) & np.uint64(1))
            << j[None, None, :, None, None]).sum(axis=2)             # (tiles, 32, T, C)
    model = vals.reshape(-1)[:n].astype(np.uint32)
    np.testing.assert_array_equal(model, _np(ref.unpack_bits_ref(words, bits, n)))
    load = ((np.arange(tiles)[:, None, None] * bits + np.arange(bits)[None, :, None])
            * cols + C * np.arange(T))                               # first word of a load
    assert (load % C == 0).all() and load.max() + C <= words.numel()
    # so a load is one 16-byte vector exactly when the buffer's base is
    # 16-byte aligned, the rule repro_unpack_bits applies to its pointer:
    # one word offset in four of a buffer gives 16-byte loads
    buf = torch.zeros(words.numel() + 3, dtype=torch.int32)
    assert sum(buf[off:].data_ptr() % 16 == 0 for off in range(4)) == 1


@pytest.mark.cuda
def test_cuda_unpack_bits_matches_plain_aligned_or_not():
    """unpack_bits on the card against its plain version at the model's n
    and b, from an aligned word buffer and from one a word off 16 bytes
    (its 4-byte load path): bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for n in UNPACK_MODEL_N:
        for bits in (1, 4, 8, 13, 32):
            vals = torch.from_numpy(_values(n, bits, seed=bits)).cuda()
            words = tpb.pack_bits(vals, bits)
            buf = torch.empty(words.numel() + 1, dtype=torch.uint32, device="cuda")
            buf[1:] = words
            for w in (words, buf[1:]):
                assert torch.equal(tpb.unpack_bits(w, bits, n).view(torch.int32),
                                   vals.view(torch.int32))


@pytest.mark.cuda
def test_cuda_flash_attention_f32_layouts_match_plain():
    """The float32 kernel on what its 4-byte copies and plan windows take:
    a q view one element off 16 bytes, odd head dims, and 140,000 keys
    (past the 2048 key tiles planned at a time), within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(1, 600, 4, 2, 120, True, 256), (2, 300, 4, 2, 33, False, 50),
             (2, 200, 4, 4, 17, False, None), (1, 140_000, 2, 1, 64, False, 4096)]
    for b, s, h, hkv, d, odd, window in cases:
        q = torch.randn((b, min(s, 256), h, d), generator=gen, device="cuda")
        if odd:
            flat = torch.empty(1 + q.numel(), device="cuda")
            q = flat[1:].view(q.shape).copy_(q)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda")
                for _ in range(2))
        kp = torch.arange(s, device="cuda", dtype=torch.int32)
        qp = kp[-q.shape[1]:]
        assert tfa.vec_ready(q) == (not odd and d % 4 == 0)
        out = tfa.flash_attention(q, k, v, qp, kp, window=window)
        plain = ref.flash_attention_ref(q, k, v, qp, kp, window=window)
        torch.testing.assert_close(out, plain, rtol=2e-5, atol=2e-5)


# -- sign_pipeline's work split (csrc/sign_pipeline.cu) ------------------------

SIGN_MODEL_N = [1, 31, 100, 32_769, 70_001]
SIGN_MODEL_GRIDS = [1, 2, 3, 7, 264]
SIGN_BATCH = 8          # rows a thread has in flight (BATCH in the kernel)


def _sign_index(n):
    """Value index of (chunk, lane, row, column of the quad): chunk c is
    quads 32·(c % 8) .. of tile c // 8, lane l its quad, thread columns
    4·quad .. + 3."""
    chunks = tpb.n_tiles(n) * tcp.SIGN_CHUNKS_PER_TILE
    cols = tpb.R * tpb.LANES
    c = np.arange(chunks)[:, None, None, None]
    lane = np.arange(tcp.SIGN_CHUNK_QUADS)[None, :, None, None]
    row = np.arange(tpb.GROUP)[None, None, :, None]
    e = np.arange(tcp.SIGN_COLS)[None, None, None, :]
    quad = (c % tcp.SIGN_CHUNKS_PER_TILE) * tcp.SIGN_CHUNK_QUADS + lane
    return ((c // tcp.SIGN_CHUNKS_PER_TILE) * tpb.GROUP + row) * cols + tcp.SIGN_COLS * quad + e


def _sign_batches(c, n):
    """chunk_batches: batches of rows of chunk c that hold values."""
    cols = tpb.R * tpb.LANES
    first = ((c // tcp.SIGN_CHUNKS_PER_TILE) * tpb.GROUP * cols
             + (c % tcp.SIGN_CHUNKS_PER_TILE) * tcp.SIGN_CHUNK_QUADS * tcp.SIGN_COLS)
    rows = min(max(-(-(n - first) // cols), 0), tpb.GROUP)
    return -(-rows // SIGN_BATCH)


def _sign_runs(chunks, grid):
    """Each warp's run of chunks [lo, hi): warp gw of W = 8·grid."""
    warps = grid * tcp.SIGN_THREADS // 32
    gw = np.arange(warps)
    return gw * chunks // warps, (gw + 1) * chunks // warps


def _butterfly(v):
    """warp_sum: the xor butterfly over the last axis (32 lanes), lane 0's
    value; float64 adds in the kernel's order."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v[..., 0]


def _sign_partials(msg, cache, chunks_of=None):
    """Pass 1's float64 partial per chunk: lane sums in row-then-column
    order, then the butterfly.  ``chunks_of`` restricts it to those chunks
    (the others stay NaN, as unwritten scratch)."""
    n = msg.size
    idx = _sign_index(n)
    a = np.abs(np.add(msg, cache, dtype=np.float32))
    vals = np.where(idx < n, a[np.minimum(idx, n - 1)], np.float32(0)).astype(np.float64)
    acc = np.zeros(vals.shape[:2])
    for r in range(tpb.GROUP):
        for e in range(tcp.SIGN_COLS):
            acc = acc + vals[:, :, r, e]
    partials = _butterfly(acc)
    if chunks_of is not None:
        keep = np.zeros(partials.size, bool)
        keep[list(chunks_of)] = True
        partials = np.where(keep, partials, np.nan)
    return partials


def _sign_total(partials):
    """The scale's float64 sum: thread t adds partials t, t + 256, ...; the
    butterfly in each warp; then warps 0..7 in order."""
    t = np.zeros(tcp.SIGN_THREADS)
    for k0 in range(0, partials.size, tcp.SIGN_THREADS):
        part = partials[k0:k0 + tcp.SIGN_THREADS]
        t[:part.size] = t[:part.size] + part
    total = 0.0
    for w in _butterfly(t.reshape(-1, 32)):
        total = total + w
    return total


def _sign_model_scale(msg, cache):
    """The kernel's scale, float32(total / n), from the model."""
    return np.float32(_sign_total(_sign_partials(msg, cache)) / np.float64(msg.size))


@pytest.mark.parametrize("grid", SIGN_MODEL_GRIDS)
@pytest.mark.parametrize("n", SIGN_MODEL_N)
def test_sign_work_split_reads_twice_and_writes_once(n, grid):
    """A numpy model of sign_pipeline_kernel's split: warp gw owns chunks
    [gw·C/W, (gw+1)·C/W), so a block owns a contiguous run of tile columns;
    pass 1 walks a warp's chunks and rows forward, pass 2 the same rows in
    reverse.  Every value < n is read once in each pass and its new cache
    written once, none >= n; every word of the tile padding is written once
    (a 16-byte store of four columns); the words and new cache the model
    makes from its scale equal the plain version's."""
    chunks = tpb.n_tiles(n) * tcp.SIGN_CHUNKS_PER_TILE
    lo, hi = _sign_runs(chunks, grid)
    np.testing.assert_array_equal(np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)]),
                                  np.arange(chunks))
    idx = _sign_index(n)
    pass1, pass2 = [], []
    for a, b in zip(lo, hi):
        seq = [(c, r) for c in range(a, b) for r in range(SIGN_BATCH * _sign_batches(c, n))]
        pass1 += seq
        back = [(c, i0 + u) for c in range(b - 1, a - 1, -1)
                for i0 in range(SIGN_BATCH * (_sign_batches(c, n) - 1), -1, -SIGN_BATCH)
                for u in range(SIGN_BATCH - 1, -1, -1)]
        assert back == seq[::-1]
        pass2 += back
    for seq in (pass1, pass2):
        c, r = np.array(seq, np.int64).reshape(-1, 2).T
        touched = idx[c, :, r].ravel()
        np.testing.assert_array_equal(np.bincount(touched[touched < n], minlength=n),
                                      np.ones(n, np.int64))
    # words: chunk c, lane l writes words tile·1024 + 4·quad .. + 3
    words_at = (idx[:, :, 0, :] // (tpb.GROUP * tpb.R * tpb.LANES) * tpb.R * tpb.LANES
                + idx[:, :, 0, :] % (tpb.R * tpb.LANES))
    assert (words_at[:, :, 0] % tcp.SIGN_COLS == 0).all()
    np.testing.assert_array_equal(np.bincount(words_at.ravel()),
                                  np.ones(chunks * 32 * tcp.SIGN_COLS, np.int64))
    # what the model writes
    msg, cache = sign_inputs(n, n)
    scale = _sign_model_scale(msg, cache)
    cor = np.add(msg, cache, dtype=np.float32)
    bit = (cor >= 0).astype(np.uint32)
    padded = np.zeros(idx.max() + 1, np.uint32)
    padded[:n] = bit
    vals = padded[idx]                                   # (chunk, lane, row, col)
    words = np.zeros(chunks * 32 * tcp.SIGN_COLS, np.uint32)
    words[words_at] = (vals << np.arange(tpb.GROUP, dtype=np.uint32)[None, None, :, None]
                       ).sum(axis=2, dtype=np.uint32)
    newc = cor - np.where(bit == 1, scale, -scale).astype(np.float32)
    w_r, s_r, c_r = ref.sign_pipeline_ref(torch.from_numpy(msg), torch.from_numpy(cache))
    np.testing.assert_array_equal(words, _np(w_r))
    np.testing.assert_allclose(float(scale), float(s_r), rtol=1e-6)
    np.testing.assert_allclose(newc, _np(c_r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", SIGN_MODEL_N)
def test_sign_scale_sum_is_the_same_whatever_the_grid(n):
    """The partials are one per chunk, whichever warp wrote them, and every
    block adds all of them in one fixed order: for every grid the model's
    scale has the same bits, and it agrees with the plain version and with
    the JAX package's jnp mean within rtol 1e-6."""
    msg, cache = sign_inputs(n, n + 1)
    chunks = tpb.n_tiles(n) * tcp.SIGN_CHUNKS_PER_TILE
    scales = set()
    for grid in SIGN_MODEL_GRIDS:
        lo, hi = _sign_runs(chunks, grid)
        partials = np.full(chunks, np.nan)
        for a, b in zip(lo, hi):                  # each warp writes its own chunks
            if b > a:
                got = _sign_partials(msg, cache, range(a, b))
                partials[a:b] = got[a:b]
        assert not np.isnan(partials).any()
        scales.add(np.float32(_sign_total(partials) / np.float64(n)).tobytes())
    assert len(scales) == 1
    scale = np.frombuffer(scales.pop(), np.float32)[0]
    _, s_r, _ = ref.sign_pipeline_ref(torch.from_numpy(msg), torch.from_numpy(cache))
    _, s_j, _ = jcp.sign_pipeline(jnp.asarray(msg), jnp.asarray(cache), interpret=True)
    np.testing.assert_allclose(float(scale), float(s_r), rtol=1e-6)
    np.testing.assert_allclose(float(scale), float(s_j), rtol=1e-6)


@pytest.mark.parametrize("n", SIGN_MODEL_N)
def test_chip_smoke_sign_model_scale_is_the_split_models(n):
    """chip_smoke.py holds the card's scale bit for bit to its own numpy
    model of the kernel's sum (the card has no JAX, so it cannot import
    this file): that model gives the same bits as the work-split model
    above, on arrays and on a 2-d view such as the Fed-LT uplink's."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    msg, cache = sign_inputs(n, n + 2)
    want = _sign_model_scale(msg, cache).tobytes()
    assert smoke.sign_model_scale(torch.from_numpy(msg), torch.from_numpy(cache)).tobytes() == want
    if n == 100:
        m2, c2 = (torch.from_numpy(a).reshape(10, 10) for a in (msg, cache))
        assert smoke.sign_model_scale(m2, c2).tobytes() == want
