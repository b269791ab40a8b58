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
from repro.core import pytree as jpt
from repro_torch.core import pytree as tpt
from repro_torch.core.error_feedback import (EFChannel, GroupedEFChannel,
                                            resync_cache)
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


# -- GroupedEFChannel: residuals at aggregation heads (the JAX package's
#    cases in tests/test_error_feedback.py, run on the port, then the port's
#    sends against jax.jit of the JAX package's on the same inputs) ----------

def _grouped_inputs(rng, n, g, d, lo=-1):
    msgs = rng.normal(scale=0.1, size=(n, d)).astype(np.float32)
    return msgs, rng.integers(lo, g, size=n).astype(np.int32)


def test_grouped_ef_telescopes_per_group():
    """Landed wires + final cache == every message each group's members
    ever offered, under churning membership and lost head wires reverted."""
    ch = GroupedEFChannel(QUANT)
    n, g, d = 12, 3, 7
    rng = np.random.default_rng(3)
    cache = ch.init_cache(torch.zeros((n, d)), g)
    total_msgs, total_landed = np.zeros((g, d)), np.zeros((g, d))
    for _ in range(30):
        msgs, groups = _grouped_inputs(rng, n, g, d)
        msgs, groups = torch.from_numpy(msgs), torch.from_numpy(groups)
        wire, cache = ch.send(None, msgs, cache, groups, g)
        total_msgs += ch.group_sum(msgs, groups, g).numpy()
        lost = torch.from_numpy(rng.random(g) < 0.3)
        cache = ch.revert(cache, wire, lost)
        total_landed += wire.numpy() * (~lost.numpy())[:, None]
    np.testing.assert_allclose(total_landed + cache.numpy(), total_msgs,
                               rtol=0, atol=1e-4)


def test_grouped_ef_matches_per_group_efchannel():
    """The head placement is exactly leaf EF applied after the merge."""
    ch, ef = GroupedEFChannel(QUANT), EFChannel(QUANT)
    n, g, d = 10, 4, 5
    rng = np.random.default_rng(4)
    cache_g = ch.init_cache(torch.zeros((n, d)), g)
    cache_e = torch.zeros((g, d))
    for _ in range(8):
        msgs, groups = _grouped_inputs(rng, n, g, d, lo=0)
        msgs, groups = torch.from_numpy(msgs * 2), torch.from_numpy(groups)
        w_g, cache_g = ch.send(None, msgs, cache_g, groups, g)
        w_e, cache_e = ef.send(None, ch.group_sum(msgs, groups, g), cache_e)
        assert torch.equal(w_g, w_e) and torch.equal(cache_g, cache_e)


def test_grouped_ef_disabled_and_masking():
    n, g, d = 6, 2, 3
    ch0 = GroupedEFChannel(Identity(), enabled=False)
    cache = ch0.init_cache(torch.zeros((n, d)), g)
    msgs = torch.arange(n * d, dtype=torch.float32).reshape(n, d)
    groups = torch.tensor([0, 0, 1, 1, -1, -1], dtype=torch.int32)
    wire, cache2 = ch0.send(None, msgs, cache, groups, g)
    assert torch.equal(cache, cache2)
    # -1 members contribute nothing; the identity wire is the group sums
    assert torch.equal(wire, torch.stack([msgs[:2].sum(0), msgs[2:4].sum(0)]))


def test_grouped_ef_revert_restores_corrected_state():
    ch = GroupedEFChannel(QUANT)
    n, g, d = 8, 2, 4
    rng = np.random.default_rng(5)
    msgs = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    groups = torch.from_numpy(rng.integers(0, g, size=n).astype(np.int32))
    wire, cache1 = ch.send(None, msgs, ch.init_cache(torch.zeros((n, d)), g),
                           groups, g)
    corrected = ch.group_sum(msgs, groups, g)       # the first cache is 0
    reverted = ch.revert(cache1, wire, torch.tensor([True, False]))
    torch.testing.assert_close(reverted[0], corrected[0], rtol=0, atol=1e-6)
    assert torch.equal(reverted[1], cache1[1])


@pytest.mark.parametrize("enabled", [True, False])
def test_grouped_ef_matches_jax(enabled):
    """Five rounds of sends and reverts in both packages from the same
    inputs: group sums, wires and caches equal jax.jit's within 1e-6 (a
    segment sum's order)."""
    n, g, d = 12, 3, 9
    ours = GroupedEFChannel(QUANT, enabled=enabled)
    theirs = je.GroupedEFChannel(jc.UniformQuantizer(levels=50, vmin=-2.0,
                                                     vmax=2.0, clip=True),
                                 enabled=enabled)
    send = jax.jit(theirs.send, static_argnums=(4,))
    revert = jax.jit(theirs.revert)
    rng = np.random.default_rng(11)
    c_t = ours.init_cache(torch.zeros((n, d)), g)
    c_j = theirs.init_cache(jnp.zeros((n, d)), g)
    for k in range(5):
        msgs, groups = _grouped_inputs(rng, n, g, d)
        lost = rng.random(g) < 0.4
        np.testing.assert_allclose(
            ours.group_sum(torch.from_numpy(msgs), torch.from_numpy(groups), g).numpy(),
            np.asarray(jax.jit(theirs.group_sum, static_argnums=2)(msgs, groups, g)),
            rtol=0, atol=1e-6)
        w_t, c_t = ours.send(None, torch.from_numpy(msgs), c_t,
                             torch.from_numpy(groups), g)
        w_j, c_j = send(jax.random.PRNGKey(k), jnp.asarray(msgs), c_j,
                        jnp.asarray(groups), g)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=1e-6)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-6)
        c_t = ours.revert(c_t, w_t, torch.from_numpy(lost))
        c_j = revert(c_j, w_j, jnp.asarray(lost))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-6)


def test_tree_helpers_match_jax():
    """tree_vdot, tree_sq_norm, tree_norm, tree_broadcast_agents and
    tree_cast on a mixed tree against the JAX package's."""
    rng = np.random.default_rng(6)
    a = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": (rng.normal(size=(5,)).astype(np.float32),)}
    b = {"w": rng.normal(size=(4, 3)).astype(np.float32),
         "b": (rng.normal(size=(5,)).astype(np.float32),)}
    ta, tb = (tree_map(torch.from_numpy, t) for t in (a, b))
    ja, jb = (jax.tree_util.tree_map(jnp.asarray, t) for t in (a, b))
    for ours, theirs in ((tpt.tree_vdot(ta, tb), jpt.tree_vdot(ja, jb)),
                         (tpt.tree_sq_norm(ta), jpt.tree_sq_norm(ja)),
                         (tpt.tree_norm(ta), jpt.tree_norm(ja))):
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    stacked = tpt.tree_broadcast_agents(ta, 3)
    for o, t in zip(tree_leaves(stacked),
                    jax.tree_util.tree_leaves(jpt.tree_broadcast_agents(ja, 3))):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    for o, t in zip(tree_leaves(tpt.tree_cast(ta, torch.bfloat16)),
                    jax.tree_util.tree_leaves(jpt.tree_cast(ja, jnp.bfloat16))):
        assert o.dtype == torch.bfloat16
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(t.astype(jnp.float32)))
