"""The port's EFChannel: telescoping, the fused path, and parity with JAX.

Mirrors ``tests/test_error_feedback.py``: through an EF channel no
information is lost,

    Σ_k wire_k + cache_K = Σ_k msg_k        (cache_0 = 0),

for every compressor, over trees, and through the fused kernel path.
Inputs are made with numpy from a seed.  The telescoping sums are compared
at atol 1e-4, the JAX test's tolerance for float32 sums over 15 rounds;
the fused path is compared with the unfused one and with the JAX package
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.core import error_feedback as je
from repro_torch.core.compression import (Identity, ScaledSign, TopK,
                                          UniformQuantizer)
from repro_torch.core.error_feedback import EFChannel, resync_cache
from repro_torch.core.pytree import tree_leaves, tree_map

QUANT = UniformQuantizer(levels=50, vmin=-2.0, vmax=2.0, clip=True)


def _msgs(seed, rounds, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5, 1.5, (rounds, n)).astype(np.float32)


def _run_channel(ch, msgs, tree=False, fused=False):
    """Thread ``msgs`` (R, n) through the channel; returns (Σ wires + final
    cache, Σ msgs) as flat numpy arrays."""
    def as_tree(x):
        x = torch.from_numpy(x)
        return {"a": x[:7], "b": x[7:].reshape(3, -1)} if tree else x

    cache = ch.init_cache(as_tree(msgs[0]))
    total = tree_map(torch.zeros_like, as_tree(msgs[0]))
    for r in range(msgs.shape[0]):
        if fused:
            wire, cache = ch.send_fused(as_tree(msgs[r]), cache)
        else:
            wire, cache = ch.send(torch.Generator().manual_seed(r),
                                  as_tree(msgs[r]), cache)
        total = tree_map(torch.add, total, wire)
    lhs = torch.cat([x.reshape(-1) for x in
                     tree_leaves(tree_map(torch.add, total, cache))])
    return lhs.numpy(), msgs.sum(axis=0).reshape(-1)


@pytest.mark.parametrize("name,compressor", [
    ("quant", QUANT), ("topk", TopK(fraction=0.3)), ("sign", ScaledSign()),
    ("identity", Identity())])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("seed,rounds", [(0, 3), (1, 8), (2, 15)])
def test_ef_telescopes_to_uncompressed_sum(name, compressor, tree, seed, rounds):
    lhs, rhs = _run_channel(EFChannel(compressor), _msgs(seed, rounds, 25), tree)
    np.testing.assert_allclose(lhs, rhs, rtol=0, atol=1e-4)


def test_ef_disabled_does_not_telescope():
    lhs, rhs = _run_channel(EFChannel(QUANT, enabled=False), _msgs(3, 10, 25))
    assert np.abs(lhs - rhs).max() > 1e-3


def test_send_fused_telescopes():
    lhs, rhs = _run_channel(EFChannel(QUANT), _msgs(5, 8, 64), fused=True)
    np.testing.assert_allclose(lhs, rhs, rtol=0, atol=1e-4)


def _tree_msg(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(8, 40)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(130,)) * 0.3).astype(np.float32)}


def test_send_fused_equals_send_bit_for_bit():
    ch = EFChannel(UniformQuantizer(levels=255, vmin=-1.0, vmax=1.0, clip=True))
    assert ch.fusable()
    msg = tree_map(torch.from_numpy, _tree_msg(0))
    cache = ch.init_cache(msg)
    for _ in range(4):
        wire_v, cache_v = ch.send(None, msg, cache)
        wire_f, cache_f = ch.send_fused(msg, cache)
        for a, b in zip(tree_leaves((wire_v, cache_v)), tree_leaves((wire_f, cache_f))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        cache = cache_f
        msg = tree_map(lambda x: x * 0.9 + 0.01, msg)


def test_send_fused_matches_jax_bit_for_bit(levels=10, vmin=-1.0, vmax=1.0):
    """The JAX send_fused, compiled, runs the Pallas kernel in interpret
    mode and decodes with XLA's rounding; the port's agrees bit for bit."""
    qj = jc.UniformQuantizer(levels=levels, vmin=vmin, vmax=vmax, clip=True)
    qt = UniformQuantizer(levels=levels, vmin=vmin, vmax=vmax, clip=True)
    msg = _tree_msg(1)
    cache = {k: (v * 0.01).astype(np.float32) for k, v in _tree_msg(2).items()}
    wire_j, cache_j = jax.jit(je.EFChannel(qj).send_fused)(
        jax.tree_util.tree_map(jnp.asarray, msg),
        jax.tree_util.tree_map(jnp.asarray, cache))
    wire_t, cache_t = EFChannel(qt).send_fused(tree_map(torch.from_numpy, msg),
                                               tree_map(torch.from_numpy, cache))
    for k in msg:
        np.testing.assert_array_equal(wire_t[k].numpy().view(np.int32),
                                      np.asarray(wire_j[k]).view(np.int32))
        np.testing.assert_array_equal(cache_t[k].numpy().view(np.int32),
                                      np.asarray(cache_j[k]).view(np.int32))


@pytest.mark.parametrize("name", ["quant", "topk", "sign"])
def test_batched_send_matches_jax_vmap(name):
    """batch=True (one message per agent row) is the JAX package's vmap."""
    jcomp = {"quant": jc.UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True),
             "topk": jc.TopK(fraction=0.3), "sign": jc.ScaledSign()}[name]
    tcomp = {"quant": UniformQuantizer(levels=10, vmin=-1, vmax=1, clip=True),
             "topk": TopK(fraction=0.3), "sign": ScaledSign()}[name]
    rng = np.random.default_rng(6)
    msg = rng.normal(size=(6, 20)).astype(np.float32) * 0.5
    cache = rng.normal(size=(6, 20)).astype(np.float32) * 0.05
    ch = je.EFChannel(jcomp)
    wire_j, cache_j = jax.jit(jax.vmap(lambda m, c: ch.send(None, m, c)))(
        jnp.asarray(msg), jnp.asarray(cache))
    wire_t, cache_t = EFChannel(tcomp).send(None, torch.from_numpy(msg),
                                            torch.from_numpy(cache), batch=True)
    if name == "sign":    # the scale is a mean: float32 sum-order rounding
        np.testing.assert_allclose(wire_t.numpy(), np.asarray(wire_j), rtol=1e-6)
        np.testing.assert_allclose(cache_t.numpy(), np.asarray(cache_j),
                                   rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(wire_t.numpy(), np.asarray(wire_j))
        np.testing.assert_array_equal(cache_t.numpy(), np.asarray(cache_j))


def test_not_fusable_cases():
    assert not EFChannel(TopK(fraction=0.5)).fusable()
    assert not EFChannel(UniformQuantizer(clip=False)).fusable()
    assert not EFChannel(QUANT, enabled=False).fusable()


def test_resync_cache_matches_jax():
    cache = {"w": np.random.default_rng(7).normal(size=(5, 3)).astype(np.float32),
             "b": np.ones((5,), np.float32)}
    crashed = np.array([True, False, False, True, False])
    ours = resync_cache(tree_map(torch.from_numpy, cache), torch.from_numpy(crashed))
    theirs = je.resync_cache(jax.tree_util.tree_map(jnp.asarray, cache), crashed)
    for k in cache:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
