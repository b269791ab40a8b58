"""The port's compressors against the JAX package's.

Inputs are made with numpy from a seed.  The JAX functions are compiled
with ``jax.jit``, as the JAX package runs them inside its rounds: XLA then
multiplies by the float32 reciprocal of Δ and contracts multiply-adds,
which the port reproduces, so quantizer outputs are compared bit for bit.
``ScaledSign``'s scale is a mean, summed in another order: allclose at
float32 rounding (rtol 1e-6).  ``RandD`` draws from another generator than
``jax.random``: distributional checks only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

RANGES = [(10, -1.0, 1.0), (255, -1.0, 1.0), (1000, -10.0, 10.0),
          (1023, -10.0, 10.0), (7, -0.3, 0.9)]


def _inputs(levels, vmin, vmax, n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    delta = (vmax - vmin) / levels
    half = (vmin + (np.arange(levels) + 0.5) * delta).astype(np.float32)
    x = rng.uniform(vmin - 3 * delta, vmax + 3 * delta, n).astype(np.float32)
    return np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                           np.nextafter(half, np.float32(-np.inf)),
                           np.array([-0.0, 0.0, vmin, vmax], np.float32), x])


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("levels", [1, 2, 3, 10, 15, 16, 255, 256, 1000, 1023,
                                    65535, 2**31])
def test_wire_index_bits(levels):
    assert tc.wire_index_bits(levels) == jc.wire_index_bits(levels)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("levels,vmin,vmax", RANGES)
def test_uniform_quantizer_bit_exact(levels, vmin, vmax, clip):
    x = _inputs(levels, vmin, vmax)
    qj = jc.UniformQuantizer(levels=levels, vmin=vmin, vmax=vmax, clip=clip)
    qt = tc.UniformQuantizer(levels=levels, vmin=vmin, vmax=vmax, clip=clip)
    ours = qt(None, torch.from_numpy(x)).numpy()
    theirs = jax.jit(lambda v: qj(None, v))(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    assert qt.wire_bits_per_scalar() == qj.wire_bits_per_scalar()


@pytest.mark.parametrize("levels,vmin,vmax", RANGES)
def test_quantize_encode_decode_bit_exact(levels, vmin, vmax):
    x = _inputs(levels, vmin, vmax, seed=1)
    idx_t = tc.quantize_encode(torch.from_numpy(x), levels, vmin, vmax)
    idx_j = jax.jit(lambda v: jc.quantize_encode(v, levels, vmin, vmax))(
        jnp.asarray(x))
    assert str(idx_t.dtype).split(".")[-1] == str(idx_j.dtype)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    dec_t = tc.quantize_decode(idx_t, levels, vmin, vmax)
    dec_j = jax.jit(lambda i: jc.quantize_decode(i, levels, vmin, vmax))(idx_j)
    np.testing.assert_array_equal(_bits(dec_t.numpy()), _bits(dec_j))
    # decode(encode(x)) is the clip=True quantizer
    q = tc.UniformQuantizer(levels=levels, vmin=vmin, vmax=vmax, clip=True)
    np.testing.assert_array_equal(_bits(dec_t.numpy()),
                                  _bits(q(None, torch.from_numpy(x)).numpy()))


@pytest.mark.parametrize("fraction", [0.1, 0.3, 0.8])
def test_top_k_matches_jax(fraction):
    x = np.random.default_rng(2).normal(size=(6, 50)).astype(np.float32)
    cj, ct = jc.TopK(fraction=fraction), tc.TopK(fraction=fraction)
    np.testing.assert_array_equal(ct(None, torch.from_numpy(x)).numpy(),
                                  np.asarray(cj(None, jnp.asarray(x))))
    # batch=True compresses each row as its own message, as vmap does
    np.testing.assert_array_equal(
        ct(None, torch.from_numpy(x), batch=True).numpy(),
        np.asarray(jax.vmap(lambda r: cj(None, r))(jnp.asarray(x))))


def test_scaled_sign_matches_jax():
    x = np.random.default_rng(3).normal(size=(5, 40)).astype(np.float32)
    x[0, :3] = 0.0                     # sign(0) := +1
    cj, ct = jc.ScaledSign(), tc.ScaledSign()
    for batch, theirs in [(False, cj(None, jnp.asarray(x))),
                          (True, jax.vmap(lambda r: cj(None, r))(jnp.asarray(x)))]:
        ours = ct(None, torch.from_numpy(x), batch=batch).numpy()
        theirs = np.asarray(theirs)
        np.testing.assert_array_equal(np.sign(ours), np.sign(theirs))
        np.testing.assert_allclose(ours, theirs, rtol=1e-6)   # mean's sum order
    assert (ct(None, torch.zeros(4)) >= 0).all()


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("fraction", [0.2, 0.8])
def test_rand_d_keeps_exactly_d(fraction, batch):
    x = torch.from_numpy(np.random.default_rng(4).uniform(1, 2, (8, 30))
                         .astype(np.float32))
    c = tc.RandD(fraction=fraction)
    g = torch.Generator().manual_seed(0)
    out = c(g, {"w": x}, batch=batch)["w"]
    rows = out.reshape(8, -1) if batch else out.reshape(1, -1)
    n = rows.shape[1]
    assert ((rows != 0).sum(dim=1) == max(1, round(fraction * n))).all()
    kept = out != 0
    assert torch.equal(out[kept], x[kept])
    again = c(torch.Generator().manual_seed(0), {"w": x}, batch=batch)["w"]
    assert torch.equal(out, again)     # same seed, same mask
    other = c(torch.Generator().manual_seed(1), {"w": x}, batch=batch)["w"]
    assert not torch.equal(out, other)


def test_rand_d_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        tc.RandD(fraction=0.5)(None, torch.ones(4))


def test_identity_and_make_compressor():
    x = torch.arange(5.0)
    assert tc.Identity()(None, x) is x
    for name in ("identity", "quant", "rand_d", "top_k", "sign"):
        ours, theirs = tc.make_compressor(name), jc.make_compressor(name)
        assert type(ours).__name__ == type(theirs).__name__
        assert ours.wire_bits_per_scalar() == theirs.wire_bits_per_scalar()
    with pytest.raises(ValueError, match="unknown compressor"):
        tc.make_compressor("nope")


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("name", ["identity", "quant"])
def test_wire_header_nbytes_matches(name, ndim):
    assert (tc.make_compressor(name).wire_header_nbytes(ndim)
            == jc.make_compressor(name).wire_header_nbytes(ndim))
