"""The port's wire codecs against the JAX package's ``repro.wire``.

The sign and sparse codecs are held on the JAX package's own compressor
outputs: the packed words, scales and values equal, and words packed by
either package decode in the other, bit for bit.

Both encode the same compressor outputs (inputs from numpy, quantized by
the compiled JAX quantizer, which the port matches bit for bit).  Byte
counts, headers and payload sizes must be equal, and the packed word
buffers equal word for word, tile padding included.  Decoding is
compared bit for bit with the JAX package's decode as XLA compiles it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels.pack_bits import unpack_bits as jax_unpack_bits
from repro.wire import codecs as jw
from repro_torch.core import compression as tc
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.wire import codecs as tw
from repro_torch.wire.message import LeafWire

CASES = [(10, -1.0, 1.0, (100,)), (255, -1.0, 1.0, (3, 5, 7)),
         (1000, -10.0, 10.0, (8, 40))]


def _quantized(shape, levels, vmin, vmax, seed=0):
    """A compressor output: the wire carries quantized values."""
    x = np.random.default_rng(seed).uniform(1.2 * vmin, 1.2 * vmax, shape)
    q = jc.UniformQuantizer(levels=levels, vmin=vmin, vmax=vmax, clip=True)
    return np.array(jax.jit(lambda v: q(None, v))(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("levels,vmin,vmax,shape", CASES)
def test_quant_codec_matches_jax(levels, vmin, vmax, shape):
    x = _quantized(shape, levels, vmin, vmax)
    cj = jw.QuantCodec(levels, vmin, vmax)
    ct = tw.QuantCodec(levels, vmin, vmax)
    mj, mt = cj.encode(jnp.asarray(x)), ct.encode(torch.from_numpy(x))
    assert (mt.nbytes, mt.header_nbytes, mt.payload_nbytes) == \
        (mj.nbytes, mj.header_nbytes, mj.payload_nbytes)
    (lj,), (lt,) = mj.leaves, mt.leaves
    assert (lt.kind, lt.shape, lt.header_nbytes, lt.payload_nbytes, lt.meta) == \
        (lj.kind, lj.shape, lj.header_nbytes, lj.payload_nbytes, lj.meta)
    np.testing.assert_array_equal(lt.payload["words"].numpy(),
                                  np.asarray(lj.payload["words"]))
    # decode: bit-exact round trip, and equal to JAX's compiled decode
    back = ct.decode(mt)
    np.testing.assert_array_equal(back.numpy().view(np.int32), x.view(np.int32))
    theirs = jax.jit(lambda w: jc.quantize_decode(
        jax_unpack_bits(w, cj.bits, x.size), levels, vmin, vmax))(
            lj.payload["words"]).reshape(shape)
    np.testing.assert_array_equal(back.numpy().view(np.int32),
                                  np.asarray(theirs).view(np.int32))
    assert ct.tree_nbytes(torch.from_numpy(x)) == cj.tree_nbytes(jnp.asarray(x))


def test_quant_codec_decodes_jax_words():
    x = _quantized((8, 40), 10, -1.0, 1.0, seed=1)
    lj = jw.QuantCodec(10, -1.0, 1.0).encode_leaf(jnp.asarray(x))
    lw = LeafWire(lj.kind, lj.shape, torch.float32,
                  {"words": torch.from_numpy(np.array(lj.payload["words"]))},
                  lj.header_nbytes, lj.payload_nbytes, dict(lj.meta))
    back = tw.QuantCodec(10, -1.0, 1.0).decode_leaf(lw)
    np.testing.assert_array_equal(back.numpy().view(np.int32), x.view(np.int32))


def test_dense_codec_matches_jax():
    x = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    mj = jw.DenseCodec().encode(jnp.asarray(x))
    mt = tw.DenseCodec().encode(torch.from_numpy(x))
    assert (mt.nbytes, mt.header_nbytes, mt.payload_nbytes) == \
        (mj.nbytes, mj.header_nbytes, mj.payload_nbytes)
    np.testing.assert_array_equal(tw.DenseCodec().decode(mt).numpy(), x)


@pytest.mark.parametrize("name", ["quant", "identity"])
def test_measure_tree_bytes_matches_jax(name):
    tree = {"w": _quantized((8, 40), 255, -1.0, 1.0, seed=3),
            "b": _quantized((3, 5, 7), 255, -1.0, 1.0, seed=4)}
    kw = dict(levels=255, vmin=-1.0, vmax=1.0, clip=True) if name == "quant" else {}
    ours = tw.measure_tree_bytes(tc.make_compressor(name, **kw),
                                 tree_map(torch.from_numpy, tree))
    theirs = jw.measure_tree_bytes(jc.make_compressor(name, **kw),
                                   jax.tree_util.tree_map(jnp.asarray, tree))
    assert ours == theirs
    codec = tc.make_compressor(name, **kw).wire_codec()
    msg = codec.encode(tree_map(torch.from_numpy, tree))
    assert [l.shape for l in msg.leaves] == [tuple(v.shape) for v in
                                             jax.tree_util.tree_leaves(tree)]
    back = codec.decode(msg)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name,codec", [
    ("identity", tw.DenseCodec), ("quant", tw.QuantCodec), ("sign", tw.SignCodec),
    ("top_k", tw.SparseCodec), ("rand_d", tw.SparseCodec)])
def test_codec_for_every_compressor(name, codec):
    kw = dict(clip=True) if name == "quant" else {}
    assert type(tw.codec_for(tc.make_compressor(name, **kw))) is codec
    assert type(jw.codec_for(jc.make_compressor(name, **kw))).__name__ == codec.__name__
    if codec is tw.SparseCodec:
        assert tw.codec_for(tc.make_compressor(name, fraction=0.3)).fraction == 0.3


# sign and sparse codecs: compressor outputs drawn by the JAX package (its
# RandD draws included), at n = 1, 100 and 4097 (index_bits 1, 7 and 13),
# and an all-zero leaf (k = 0 for the sparse codec, -0.0 after the sign
# codec's decode)
SIGN_SPARSE_N = (1, 100, 4097)


def _compressed(name, n, seed):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    if name == "zeros":
        return np.zeros(n, np.float32)
    c = {"sign": jc.ScaledSign(), "top_k": jc.TopK(0.1),
         "rand_d": jc.RandD(0.2)}[name]
    return np.array(jax.jit(lambda v: c(jax.random.PRNGKey(seed), v))(jnp.asarray(x)))


def _port_leaf(lj, payload):
    return LeafWire(lj.kind, lj.shape, torch.float32, payload, lj.header_nbytes,
                    lj.payload_nbytes, dict(lj.meta))


def _check_crossing(cj, ct, x):
    """Port and JAX encodings of ``x`` equal; each decodes the other's."""
    lj, lt = cj.encode_leaf(jnp.asarray(x)), ct.encode_leaf(torch.from_numpy(x))
    assert (lt.kind, lt.shape, lt.header_nbytes, lt.payload_nbytes, lt.meta) == \
        (lj.kind, lj.shape, lj.header_nbytes, lj.payload_nbytes, lj.meta)
    assert set(lt.payload) == set(lj.payload)
    for key in lj.payload:
        np.testing.assert_array_equal(
            lt.payload[key].numpy().view(np.int32),
            np.asarray(lj.payload[key]).view(np.int32), err_msg=key)
    # port words through the JAX decode, JAX words through the port's
    theirs = cj.decode_leaf(dataclasses.replace(lj, payload={
        k: jnp.asarray(v.numpy()) for k, v in lt.payload.items()}))
    ours = ct.decode_leaf(_port_leaf(lj, {
        k: torch.from_numpy(np.array(v)) for k, v in lj.payload.items()}))
    return np.asarray(theirs), ours.numpy()


@pytest.mark.parametrize("n", SIGN_SPARSE_N)
@pytest.mark.parametrize("what", ["sign", "zeros"])
def test_sign_codec_words_cross_both_ways(what, n):
    x = _compressed(what, n, seed=n)
    theirs, ours = _check_crossing(jw.SignCodec(), tw.SignCodec(), x)
    want = x if what == "sign" else -x       # an all-zero leaf decodes to -0.0
    for got in (theirs, ours):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tw.SignCodec().tree_nbytes(torch.from_numpy(x)) == \
        jw.SignCodec().tree_nbytes(jnp.asarray(x))


@pytest.mark.parametrize("n", SIGN_SPARSE_N)
@pytest.mark.parametrize("what,fraction", [("top_k", 0.1), ("rand_d", 0.2),
                                           ("zeros", 0.2)])
def test_sparse_codec_words_cross_both_ways(what, fraction, n):
    x = _compressed(what, n, seed=n)
    cj, ct = jw.SparseCodec(fraction), tw.SparseCodec(fraction)
    theirs, ours = _check_crossing(cj, ct, x)
    for got in (theirs, ours):
        np.testing.assert_array_equal(got.view(np.int32), x.view(np.int32))
    leaf = ct.encode_leaf(torch.from_numpy(x))
    assert leaf.meta == {"bits": tw.index_bits(n), "k": int(np.count_nonzero(x))}
    assert ct.tree_nbytes(torch.from_numpy(x)) == cj.tree_nbytes(jnp.asarray(x))


def test_index_bits_matches_jax():
    for n in (1, 2, 3, 100, 128, 129, 4097, 70_001, 2**24):
        assert tw.index_bits(n) == jw.index_bits(n)
    assert [tw.index_bits(n) for n in (1, 100, 4097, 70_001, 2**24)] == [1, 7, 13, 17, 24]


@pytest.mark.parametrize("name", ["sign", "top_k", "rand_d"])
def test_measure_tree_bytes_sign_sparse_match_jax(name):
    rng = np.random.default_rng(5)
    tree = {"w": rng.normal(size=(8, 40)).astype(np.float32),
            "b": rng.normal(size=(3, 5, 7)).astype(np.float32)}
    tree["w"][0, :7] = 0.0        # the sparse codec counts actual nonzeros
    ours = tw.measure_tree_bytes(tc.make_compressor(name),
                                 tree_map(torch.from_numpy, tree))
    theirs = jw.measure_tree_bytes(jc.make_compressor(name),
                                   jax.tree_util.tree_map(jnp.asarray, tree))
    assert ours == theirs
    codec = tc.make_compressor(name).wire_codec()
    assert codec.tree_nbytes(tree_map(torch.from_numpy, tree)) == \
        jc.make_compressor(name).wire_codec().tree_nbytes(
            jax.tree_util.tree_map(jnp.asarray, tree))


def test_leaf_accounting_matches_jax():
    for n in (1, 31, 32, 33, 100, 10_000):
        for levels in (1, 10, 255, 1023):
            assert (tw.QuantCodec(levels).leaf_nbytes((n,))
                    == jw.QuantCodec(levels).leaf_nbytes((n,)))
            assert (tw.QuantCodec(levels).wire_bits_per_scalar_measured(n)
                    == jw.QuantCodec(levels).wire_bits_per_scalar_measured(n))
        assert tw.DenseCodec().leaf_nbytes((n, 2)) == jw.DenseCodec().leaf_nbytes((n, 2))
        assert tw.SignCodec().leaf_nbytes((n,)) == jw.SignCodec().leaf_nbytes((n,))
        for f in (0.1, 0.2, 0.8):
            assert (tw.SparseCodec(f).leaf_nbytes((n, 3))
                    == jw.SparseCodec(f).leaf_nbytes((n, 3)))
