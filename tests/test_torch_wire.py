"""The port's wire codecs against the JAX package's ``repro.wire``.

Both encode the same compressor outputs (inputs from numpy, quantized by
the compiled JAX quantizer, which the port matches bit for bit).  Byte
counts, headers and payload sizes must be equal, and the packed word
buffers equal word for word, tile padding included.  Decoding is
compared bit for bit with the JAX package's decode as XLA compiles it.
"""
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


@pytest.mark.parametrize("name", ["sign", "top_k", "rand_d"])
def test_unported_codecs_raise(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        tw.codec_for(tc.make_compressor(name))


def test_leaf_accounting_matches_jax():
    for n in (1, 31, 32, 33, 100, 10_000):
        for levels in (1, 10, 255, 1023):
            assert (tw.QuantCodec(levels).leaf_nbytes((n,))
                    == jw.QuantCodec(levels).leaf_nbytes((n,)))
            assert (tw.QuantCodec(levels).wire_bits_per_scalar_measured(n)
                    == jw.QuantCodec(levels).wire_bits_per_scalar_measured(n))
        assert tw.DenseCodec().leaf_nbytes((n, 2)) == jw.DenseCodec().leaf_nbytes((n, 2))
