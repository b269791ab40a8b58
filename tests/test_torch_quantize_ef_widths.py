"""``quantize_ef`` at every width the deploy round gives it, and
``pack_bits`` from narrow level ints, against the JAX package's kernels.

On the CPU the port runs each kernel's plain version; the JAX kernels run
in interpret mode under ``jax.jit``, as the JAX package's own tests run
them.  Inputs are made with numpy from a seed and handed to both.

Tolerance: none.  Wires and words are compared int for int, new caches
bit for bit in their dtype.  The quantize step computes in float32
whatever msg's and cache's dtypes, and writes the new cache in msg's
dtype rounded to nearest even, as the Pallas kernel does; every finite
bf16 and fp16 value (subnormals and infinities included) is a msg here.

The pack kernel's thread map and its bit arithmetic for uint8, uint16 and
32-bit values (csrc/pack_bits.cu) are modelled in numpy and held to the
plain version: the CUDA kernels run only on the card (chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels import pack_bits as jpb
from repro.kernels import quantize_ef as jqe
from repro_torch.core.compression import quantize_encode
from repro_torch.core.deploy import DeployFedLT
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import pack_bits as tpb
from repro_torch.kernels import quantize_ef as tqe
from repro_torch.models.config import ModelConfig
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
      torch.float16: np.float16}
FLOATS = (torch.float32, torch.bfloat16, torch.float16)
PAIRS = [(m, c) for m in FLOATS for c in FLOATS]
LEVELS = (255, 1023)
VMIN, VMAX = -1.0, 1.0


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array of float32, bf16 or fp16 as a tensor of that dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as integers of its width (floats by bit pattern)."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.view(width).numpy().astype(np.int64) & ((1 << 8 * t.element_size()) - 1)


def _torch_ints(t):
    return torch.from_numpy(_bits(t))


def _every_value(dtype) -> np.ndarray:
    """Every finite and infinite value of a 16-bit float type as float32
    (float32 itself: a spread of magnitudes), NaN left out."""
    if dtype == torch.float32:
        rng = np.random.default_rng(1)
        x = rng.standard_normal(60_000) * 10.0 ** rng.integers(-40, 5, 60_000)
        return np.concatenate([x, [np.inf, -np.inf, 0.0, -0.0]]).astype(np.float32)
    x = np.arange(2**16, dtype=np.uint16).view(NP[dtype]).astype(np.float32)
    return x[~np.isnan(x)]


def pair_inputs(m_dtype, c_dtype, levels: int, seed: int):
    """msg and cache (numpy, in their dtypes): every value of msg's type
    with a small random cache; then each half-level boundary, its float32
    neighbours, and values out of range, as a msg rounded to its type and
    the rest in the cache (exact when the cache holds it, so msg + cache is
    the boundary itself in float32)."""
    rng = np.random.default_rng(seed)
    delta = (VMAX - VMIN) / levels
    half = (VMIN + (np.arange(levels) + 0.5) * delta).astype(np.float32)
    special = np.concatenate([
        half, np.nextafter(half, np.float32(np.inf)), np.nextafter(half, np.float32(-np.inf)),
        np.array([VMIN, VMAX, 3 * VMIN, 3 * VMAX, VMIN - delta, VMAX + delta],
                 np.float32)])
    every = _every_value(m_dtype)
    msg = np.concatenate([every, special]).astype(NP[m_dtype])
    rest = special - special.astype(NP[m_dtype]).astype(np.float32)
    cache = np.concatenate([rng.uniform(-delta, delta, every.size), rest])
    return msg, cache.astype(NP[c_dtype])


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("m_dtype,c_dtype", PAIRS,
                         ids=[f"{_name(m)}-{_name(c)}" for m, c in PAIRS])
def test_quantize_ef_matches_pallas_at_every_dtype_pair(m_dtype, c_dtype, levels):
    """ops.quantize_ef (the plain version on the CPU) against the Pallas
    kernel under jax.jit: the wire (uint8 for L = 255, uint16 for 1023)
    and the new cache in msg's dtype, bit for bit."""
    msg, cache = pair_inputs(m_dtype, c_dtype, levels, seed=levels)
    wire_t, newc_t = ops.quantize_ef(_torch(msg), _torch(cache), levels=levels,
                                     vmin=VMIN, vmax=VMAX)
    wire_j, newc_j = jqe.quantize_ef(jnp.asarray(msg), jnp.asarray(cache), levels=levels,
                                     vmin=VMIN, vmax=VMAX, interpret=True)
    assert wire_t.dtype == (torch.uint8 if levels <= 255 else torch.uint16)
    assert _name(wire_t.dtype) == str(wire_j.dtype)
    assert newc_t.dtype == m_dtype and str(newc_j.dtype) == _name(m_dtype)
    np.testing.assert_array_equal(_bits(wire_t), np.asarray(wire_j).astype(np.int64))
    np.testing.assert_array_equal(_bits(newc_t), _bits(_torch(np.asarray(newc_j))))


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("dtype", FLOATS, ids=_name)
def test_quantize_ef_without_cache_is_quantize_encode(dtype, levels):
    """The downlink's form (cache None): the wire of msg alone, no new
    cache; equal to quantize_encode of msg in float32, the port's and the
    JAX package's (jax.jit), int for int."""
    msg, _ = pair_inputs(dtype, dtype, levels, seed=3)
    x = _torch(msg)
    wire, none = ops.quantize_ef(x, None, levels=levels, vmin=VMIN, vmax=VMAX)
    assert none is None and wire.shape == x.shape
    want = quantize_encode(x.to(torch.float32), levels, VMIN, VMAX)
    assert want.dtype == wire.dtype and torch.equal(_torch_ints(want), _torch_ints(wire))
    want_j = jax.jit(lambda m: jc.quantize_encode(m, levels, VMIN, VMAX))(
        jnp.asarray(msg.astype(np.float32)))
    np.testing.assert_array_equal(_bits(wire), np.asarray(want_j).astype(np.int64))


@pytest.mark.parametrize("m_dtype,c_dtype", PAIRS,
                         ids=[f"{_name(m)}-{_name(c)}" for m, c in PAIRS])
def test_pieced_plain_version_equals_the_whole_leaf(monkeypatch, m_dtype, c_dtype):
    """ref.quantize_ef_ref a piece of PIECE values at a time: with pieces of
    1000 values over a (3, 7001) leaf, wire and new cache equal those of one
    piece holding the whole leaf, with and without a cache, and msg and
    cache stay as they were."""
    rng = np.random.default_rng(5)
    msg = _torch(rng.uniform(-1.3, 1.3, (3, 7001)).astype(NP[m_dtype]))
    cache = _torch(rng.uniform(-0.01, 0.01, (3, 7001)).astype(NP[c_dtype]))
    m0, c0 = msg.clone(), cache.clone()
    q = dict(levels=1023, vmin=VMIN, vmax=VMAX)
    whole = [ref.quantize_ef_ref(msg, cache, **q), ref.quantize_ef_ref(msg, None, **q)]
    monkeypatch.setattr(ref, "PIECE", 1000)
    pieced = [ref.quantize_ef_ref(msg, cache, **q), ref.quantize_ef_ref(msg, None, **q)]
    for (w, nc), (w_p, nc_p) in zip(whole, pieced):
        assert torch.equal(_torch_ints(w), _torch_ints(w_p)) and w_p.shape == msg.shape
        assert (nc is None and nc_p is None) or torch.equal(_torch_ints(nc), _torch_ints(nc_p))
    assert pieced[0][1].dtype == m_dtype
    assert torch.equal(_torch_ints(msg), _torch_ints(m0))
    assert torch.equal(_torch_ints(cache), _torch_ints(c0))


# -- the wrapper on the card's route (meta tensors: shapes, no launch) --------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_quantize_ef_wrapper_takes_every_pair_and_no_cache(monkeypatch):
    """Off the CPU the wrapper launches the kernel with msg's and cache's
    type codes, a null cache and new cache for the no-cache form, and a
    64-bit n past 2**31 (no size check); it refuses float64, a shape
    mismatch and L > 65535, and the deploy round refuses such an L."""
    seen = []
    monkeypatch.setattr(_build, "meta_hook", lambda name, args: seen.append((name, args)))
    for m_dtype, c_dtype in PAIRS:
        wire, newc = ops.quantize_ef(_meta(2, 4096, dtype=m_dtype),
                                     _meta(2, 4096, dtype=c_dtype), levels=255)
        assert wire.dtype == torch.uint8 and newc.dtype == m_dtype
        assert wire.shape == newc.shape == (2, 4096)
        args = seen.pop()[1]
        assert args[-2:] == (tqe.DTYPE_CODES[m_dtype], tqe.DTYPE_CODES[c_dtype])
    wire, none = ops.quantize_ef(_meta(2**31 + 4097, dtype=torch.bfloat16), None,
                                 levels=1023)
    assert none is None and wire.dtype == torch.uint16 and wire.numel() == 2**31 + 4097
    name, args = seen.pop()
    assert name == "quantize_ef" and args[1] is None and args[3] is None
    assert args[4] == 2**31 + 4097 and args[-2:] == (1, 1)
    with pytest.raises(TypeError):
        ops.quantize_ef(_meta(8, dtype=torch.float64), _meta(8))
    with pytest.raises(ValueError):
        ops.quantize_ef(_meta(8), _meta(9))
    for levels in (0, 65536):
        with pytest.raises(ValueError):
            ops.quantize_ef(torch.zeros(8), torch.zeros(8), levels=levels)
    cfg = ModelConfig(name="t", arch_type="dense", n_layers=1, d_model=8, n_heads=1,
                      n_kv_heads=1, d_ff=16, vocab_size=8, max_seq=8, chunk_size=8)
    with pytest.raises(ValueError):
        DeployFedLT(cfg=cfg, levels=70_000)
    assert not DeployFedLT(cfg=cfg, levels=70_000, compress=False).compress
    assert DeployFedLT(cfg=cfg, levels=65535).levels == 65535


def test_pack_bits_reads_narrow_ints_where_they_lie(monkeypatch):
    """Off the CPU pack_bits hands the kernel uint8, bool, uint16, int32
    and uint32 values as they are (no int32 copy), with their width;
    int8 and int16 widen to int32 (their negatives keep their sign bits);
    and n may pass 2**31, in unpack_bits of its words too."""
    seen = []
    monkeypatch.setattr(_build, "meta_hook", lambda name, args: seen.append(args))
    for dtype, width in ((torch.uint8, 1), (torch.bool, 1), (torch.uint16, 2),
                         (torch.int32, 4), (torch.uint32, 4), (torch.int8, 4),
                         (torch.int16, 4)):
        x = _meta(3, 50_000, dtype=dtype)
        words = ops.pack_bits(x, 8)
        args = seen.pop()
        assert words.dtype == torch.uint32 and words.numel() == tpb.n_tiles(x.numel()) * 8 * 1024
        assert args[5] == width and args[2] == x.numel()
        assert (args[0].untyped_storage() is x.untyped_storage()) == (dtype not in (
            torch.int8, torch.int16)), dtype
    words = ops.pack_bits(_meta(2**31 + 4097, dtype=torch.uint8), 8)
    assert seen.pop()[2] == 2**31 + 4097
    ops.unpack_bits(words, 8, 2**31 + 4097)
    assert seen.pop()[2:] == (2**31 + 4097, 8, tpb.n_tiles(2**31 + 4097))


# -- pack_bits from narrow ints against the JAX kernel -------------------------

PACK_N = (100, 32_768, 70_001)


@pytest.mark.parametrize("bits", [1, 4, 8, 10, 16])
@pytest.mark.parametrize("n", PACK_N)
def test_pack_bits_from_narrow_ints_matches_the_uint32_path_and_pallas(n, bits):
    """ops.pack_bits from uint8 (b ≤ 8), uint16 (b ≤ 16) and int32 values
    equals pack_bits of the same values as uint32 and the Pallas kernel's
    words (jax.jit, interpret mode), word for word, tile padding included;
    the JAX package decodes them."""
    rng = np.random.default_rng(n + bits)
    vals = rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jpb.pack_bits(jnp.asarray(vals), bits, interpret=True))
    as_u32 = ops.pack_bits(torch.from_numpy(vals), bits)
    np.testing.assert_array_equal(as_u32.numpy(), want)
    for np_dtype in (np.uint8, np.uint16, np.int32):
        if bits > 8 * np.dtype(np_dtype).itemsize:
            continue
        words = ops.pack_bits(torch.from_numpy(vals.astype(np_dtype)), bits)
        assert words.dtype == torch.uint32
        np.testing.assert_array_equal(words.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jpb.unpack_bits(
        jnp.asarray(as_u32.numpy()), bits, n, interpret=True)), vals)


def test_pack_bits_of_negative_int32_is_twos_complement():
    """Negative int32 values pack as their two's complement uint32 words
    at b = 32, as the JAX kernel's uint32 cast gives them."""
    vals = np.random.default_rng(0).integers(-2**31, 2**31, 40_000, dtype=np.int64)
    vals = vals.astype(np.int32)
    words = ops.pack_bits(torch.from_numpy(vals), 32)
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jpb.pack_bits(jnp.asarray(vals.view(np.uint32)), 32,
                                                interpret=True)))


# -- a numpy model of pack_bits_kernel (csrc/pack_bits.cu) ---------------------

def _byte_perm(x, y, s: int):
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: byte k of the result
    is byte (s >> 4k) & 7 of the eight bytes of y:x."""
    xy = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for k in range(4):
        sel = np.uint64((s >> (4 * k)) & 7)
        out |= ((xy >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out.astype(np.uint32)


def _move(x, s: int, j: int):
    """``s >= j ? x << (s - j) : x >> (j - s)`` on uint32."""
    x = x.astype(np.uint64)
    y = x << np.uint64(s - j) if s >= j else x >> np.uint64(j - s)
    return (y & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _planes_u8(rows, j):
    """plane<J> for uint8 rows (32, T) of 4 columns a byte each."""
    a = []
    for r0 in (0, 8, 16, 24):
        acc = np.zeros(rows.shape[1], np.uint32)
        for s in range(8):
            acc |= _move(rows[r0 + s], s, j) & np.uint32(0x01010101 << s)
        a.append(acc)
    t0, t1 = _byte_perm(a[0], a[1], 0x5140), _byte_perm(a[2], a[3], 0x5140)
    t2, t3 = _byte_perm(a[0], a[1], 0x7362), _byte_perm(a[2], a[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _planes_u16(rows, j):
    """plane<J> for uint16 rows (32, 2, T): two columns a register."""
    out = []
    for h in range(2):
        a = []
        for g in range(2):
            acc = np.zeros(rows.shape[2], np.uint32)
            for s in range(16):
                acc |= _move(rows[16 * g + s, h], s, j) & np.uint32(0x00010001 << s)
            a.append(acc)
        out += [_byte_perm(a[0], a[1], 0x5410), _byte_perm(a[0], a[1], 0x7632)]
    return out


def _planes_u32(rows, bits):
    """gather32 for 32-bit rows (32, 4, T): the MAXB plane accumulators
    (MAXB the smallest power of two that holds b), row i's bit j into
    bit i of plane j as the row arrives; a list of MAXB planes, each the
    4 columns' words."""
    maxb = 1 << (bits - 1).bit_length()
    acc = np.zeros((maxb, 4, rows.shape[2]), np.uint32)
    for i in range(32):
        for j in range(maxb):
            acc[j] |= _move(rows[i], i, j) & np.uint32(1 << i)
    return [list(a) for a in acc]


def pack_model(vals: np.ndarray, bits: int, aligned: bool = True) -> np.ndarray:
    """pack_bits_kernel's words: block = tile, thread t = columns 4t ..
    4t + 3; row i of them = values (tile·32 + i)·1024 + 4t .. + 3, read as
    one vector when the base is aligned and the tile lies inside n, else
    value by value with 0 past n; each plane j < bits stored as the 4
    columns' words at (tile·bits + j)·1024 + 4t, planes at or above the
    width as zeros.  Every value index is read once, every word written
    once."""
    n, width = vals.size, 8 * vals.dtype.itemsize
    T, C, cols = tpb.UNPACK_THREADS, tpb.UNPACK_COLS, tpb.R * tpb.LANES
    tiles = tpb.n_tiles(n)
    words = np.full(tiles * bits * cols, 0xDEADBEEF, np.uint32)
    written = np.zeros(words.size, np.int64)
    read = np.zeros(n, np.int64)
    for tile in range(tiles):
        first = (tile * tpb.GROUP + np.arange(tpb.GROUP))[:, None] * cols + C * np.arange(T)
        vec = aligned and (tile + 1) * tpb.GROUP * cols <= n
        idx = first[:, None, :] + np.arange(C)[None, :, None]          # (32, 4, T)
        inside = idx < n
        read += np.bincount(idx[inside], minlength=n)
        assert not vec or inside.all()
        x = np.where(inside, vals[np.minimum(idx, n - 1)], 0).astype(np.uint32)
        if width == 8:
            rows = x[:, 0] | (x[:, 1] << 8) | (x[:, 2] << 16) | (x[:, 3] << 24)
            plane = lambda j: _planes_u8(rows, j)
        elif width == 16:
            rows = np.stack([x[:, 0] | (x[:, 1] << 16), x[:, 2] | (x[:, 3] << 16)], axis=1)
            plane = lambda j: _planes_u16(rows, j)
        else:
            planes32 = _planes_u32(x, bits)
            plane = lambda j: planes32[j]
        for j in range(bits):
            got = plane(j) if j < width else [np.zeros(T, np.uint32)] * 4
            at = (tile * bits + j) * cols + C * np.arange(T)
            assert (at % 4 == 0).all()                 # one 16-byte store
            for c in range(C):
                words[at + c] = got[c]
                written[at + c] += 1
    assert (read == 1).all() and (written == 1).all()
    return words


@pytest.mark.parametrize("np_dtype,bits", [(np.uint8, 1), (np.uint8, 4), (np.uint8, 8),
                                           (np.uint8, 11), (np.uint16, 4), (np.uint16, 13),
                                           (np.uint16, 16), (np.uint32, 4), (np.uint32, 13),
                                           (np.uint32, 32)])
@pytest.mark.parametrize("n", [1, 31, 100, 32_768, 32_769, 70_001])
def test_pack_thread_map_and_bit_arithmetic(n, np_dtype, bits):
    """The model of pack_bits_kernel (thread map, tail padding, the uint8
    byte transposes, the uint16 half words, the 32-bit path, zero planes
    past the width) against the plain version, word for word, aligned
    and value by value."""
    rng = np.random.default_rng(n * 7 + bits)
    width = 8 * np.dtype(np_dtype).itemsize
    hi = 2 ** min(bits, width)
    vals = rng.integers(0, hi, n, dtype=np.uint64).astype(np_dtype)
    want = ref.pack_bits_ref(torch.from_numpy(vals.astype(np.int64)), bits).numpy()
    for aligned in ((True, False) if n in (32_769, 100) else (True,)):
        np.testing.assert_array_equal(pack_model(vals, bits, aligned), want)


def test_a_wrong_byte_order_is_seen():
    """The model reads what it says: swapping two byte permutes of the
    uint8 path changes the words."""
    rows = np.random.default_rng(0).integers(0, 2**32, (32, 8), dtype=np.uint64).astype(np.uint32)
    good = _planes_u8(rows, 3)
    a = [np.bitwise_or.reduce([_move(rows[r0 + s], s, 3) & np.uint32(0x01010101 << s)
                               for s in range(8)]) for r0 in (0, 8, 16, 24)]
    t0, t1 = _byte_perm(a[0], a[1], 0x5140), _byte_perm(a[2], a[3], 0x5140)
    assert not np.array_equal(_byte_perm(t0, t1, 0x7632), good[0])
    # column c's word: bit i = bit 3 of row i's byte c
    for c in range(4):
        want = sum((((rows[i] >> np.uint32(8 * c + 3)) & np.uint32(1)).astype(np.uint64)
                    << np.uint64(i)) for i in range(32)).astype(np.uint32)
        np.testing.assert_array_equal(good[c], want)


def test_deploy_round_quantizes_through_ops(monkeypatch):
    """DeployFedLT's unpacked uplink, unfused packed uplink and downlink
    call ops.quantize_ef, once per leaf each; the fused packed uplink
    leaves it the leaves under one tile."""
    cfg = ModelConfig(name="t", arch_type="dense", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=1024, vocab_size=64, max_seq=32, chunk_size=16,
                      dtype="float32")
    calls = []
    real = ops.quantize_ef

    def spy(msg, cache, **kw):
        calls.append((tuple(msg.shape), cache is None))
        return real(msg, cache, **kw)

    monkeypatch.setattr(ops, "quantize_ef", spy)
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.data.synthetic import make_batch, stack_batches
    alg = DeployFedLT(cfg=cfg, n_epochs=1)
    state = alg.init(2, generator=torch.Generator().manual_seed(0), device="cpu")
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    batch = stack_batches([make_batch(cfg, g, 1, 16, device="cpu") for g in gens])
    leaves = tree_leaves(state.x)
    for pack in (False, True):
        calls.clear()
        dataclasses.replace(alg, pack_wire=pack, fuse_pipeline=False).round_step(state, batch)
        up = [c for c in calls if not c[1]]
        down = [c for c in calls if c[1]]
        assert sorted(up) == sorted((tuple(x.shape), False) for x in leaves)
        assert sorted(down) == sorted((tuple(x.shape[1:]), True) for x in leaves)
    calls.clear()                      # the fused packed uplink: quant_pipeline instead
    dataclasses.replace(alg, pack_wire=True).round_step(state, batch)
    big = [x for x in leaves if x.numel() >= tpb._TILE_VALS]
    assert big and len([c for c in calls if not c[1]]) == len(leaves) - len(big)
    assert len([c for c in calls if c[1]]) == len(leaves)


@pytest.mark.parametrize("route", [dict(), dict(pack_wire=True),
                                   dict(pack_wire=True, fuse_pipeline=False),
                                   dict(compress=False)],
                         ids=["unpacked", "packed-fused", "packed-unfused", "no-compress"])
def test_chip_smoke_derives_the_rounds_wire_launches(monkeypatch, route):
    """chip_smoke.py holds every training round's launches to counts it
    derives from the model's leaves (quant_launches); here the calls a
    round makes to the wire's dispatchers, counted on the CPU, are those
    counts on each route."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.data.synthetic import make_batch, stack_batches
    cfg = ModelConfig(name="t", arch_type="dense", n_layers=2, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=1024, vocab_size=64, max_seq=32, chunk_size=16,
                      dtype="bfloat16")
    calls = {}
    for name in ("quantize_ef", "quant_pipeline", "pack_bits", "unpack_bits"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _r(*a, **k))[1])
    alg = DeployFedLT(cfg=cfg, n_epochs=1, **route)
    state = alg.init(2, generator=torch.Generator().manual_seed(0), device="cpu")
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    alg.round_step(state, stack_batches([make_batch(cfg, g, 1, 16, device="cpu")
                                         for g in gens]))
    assert calls == smoke.quant_launches(alg, 2)
