"""The port's synthetic LM data and standalone optimizers against the JAX
package.

The token streams come from a ``torch.Generator`` and cannot reproduce
``jax.random``'s, so they are held to the JAX package's own properties
(``tests/test_data_and_optim.py``): in range, deterministic per seed,
heterogeneous across agents, the VLM layout; plus the Gamma draws'
moments and statistics of the streams measured alike on both packages.
``_mrope_positions`` is deterministic and equals JAX's bit for bit.
``sgd`` and Adam run on the same numpy inputs in both packages.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.core import pytree as _jax_core  # noqa: F401  (before repro.optim: cycle)
from repro.data import synthetic as jsyn
from repro.optim import solvers as jsolvers
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.core.pytree import tree_leaves
from repro_torch.data import synthetic as tsyn
from repro_torch.optim import solvers as tsolvers


def test_markov_tokens_deterministic_and_in_range():
    a = tsyn.markov_tokens(tsyn.seeded(3), 4, 64, 1000)
    b = tsyn.markov_tokens(tsyn.seeded(3), 4, 64, 1000)
    assert torch.equal(a, b)
    assert a.shape == (4, 64) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    assert not torch.equal(a, tsyn.markov_tokens(tsyn.seeded(4), 4, 64, 1000))


@pytest.mark.parametrize("vocab", [100, 100352])
def test_markov_tokens_stay_below_the_clamped_vocab(vocab):
    """The transition table spans min(vocab, 4096) tokens, as JAX's."""
    t = tsyn.markov_tokens(tsyn.seeded(5), 2, 256, vocab)
    assert int(t.max()) < min(vocab, 4096)


def _stats(tokens: np.ndarray):
    """(distinct tokens, share of the 8 most frequent) per stream, averaged."""
    distinct = [len(np.unique(row)) for row in tokens]
    top = [np.sort(np.bincount(row, minlength=4096))[-8:].sum() / row.size
           for row in tokens]
    return float(np.mean(distinct)), float(np.mean(top))


def test_markov_tokens_statistics_match_jax():
    """Eight 2048-token streams over a 4096 vocab from each package: the
    mean number of distinct tokens within 5% of JAX's, and the share of the
    8 most frequent within a factor 1.5 of JAX's."""
    ours = np.concatenate([tsyn.markov_tokens(tsyn.seeded(s), 2, 2048, 4096).numpy()
                           for s in range(4)])
    theirs = np.concatenate([np.asarray(jsyn.markov_tokens(jax.random.PRNGKey(s), 2,
                                                           2048, 4096))
                             for s in range(4)])
    (d_t, top_t), (d_j, top_j) = _stats(ours), _stats(theirs)
    assert abs(d_t / d_j - 1) < 0.05, (d_t, d_j)
    assert 1 / 1.5 < top_t / top_j < 1.5, (top_t, top_j)


@pytest.mark.parametrize("alpha", [0.05, 2.0])
def test_gamma_draws_have_gamma_moments(alpha):
    """The Dirichlet rows' Gamma(alpha) draws (alpha < 1 through the
    U**(1/alpha) boost): mean and variance within 5% of alpha over 200,000
    draws, as Gamma(alpha, 1) has."""
    g = tsyn._gamma(alpha, (200_000,), tsyn.seeded(0)).numpy()
    assert abs(g.mean() / alpha - 1) < 0.05 and abs(g.var() / alpha - 1) < 0.05
    assert (g >= 0).all()


def test_agents_heterogeneous_streams():
    cfg = smoke_variant(ARCHS["stablelm-1.6b"])
    batch = tsyn.agent_batches(cfg, n_agents=3, batch_per_agent=2, seq=32, round_idx=0,
                               device="cpu")
    toks = batch["tokens"]
    assert toks.shape == (3, 2, 32)
    assert not torch.equal(toks[0], toks[1])
    assert torch.equal(batch["labels"], toks)
    again = tsyn.agent_batches(cfg, n_agents=3, batch_per_agent=2, seq=32, round_idx=0,
                               device="cpu")
    assert torch.equal(again["tokens"], toks)
    other = tsyn.agent_batches(cfg, n_agents=3, batch_per_agent=2, seq=32, round_idx=1,
                               device="cpu")
    assert not torch.equal(other["tokens"], toks)


def test_vlm_batch_layout_matches_jax():
    cfg, cfg_j = smoke_variant(ARCHS["qwen2-vl-7b"]), jax_smoke(JAX_ARCHS["qwen2-vl-7b"])
    b = tsyn.make_batch(cfg, tsyn.seeded(0), 2, 64, device="cpu")
    bj = jsyn.make_batch(cfg_j, jax.random.PRNGKey(0), 2, 64)
    s_vis = b["extra_embeds"].shape[1]
    assert s_vis == bj["extra_embeds"].shape[1]
    assert b["tokens"].shape[1] + s_vis == 64
    assert b["labels"].shape == (2, 64)
    assert bool((b["labels"][:, :s_vis] == -1).all())
    assert str(b["extra_embeds"].dtype).split(".")[-1] == str(bj["extra_embeds"].dtype)
    np.testing.assert_array_equal(b["positions"].numpy(), np.asarray(bj["positions"]))


def test_audio_batch_predicts_its_tokens():
    cfg = smoke_variant(ARCHS["musicgen-large"])
    b = tsyn.make_batch(cfg, tsyn.seeded(1), 2, 16, device="cpu")
    assert set(b) == {"tokens", "labels"} and torch.equal(b["tokens"], b["labels"])


@pytest.mark.parametrize("batch,s_vis,s_txt", [(1, 16, 48), (2, 10, 5), (3, 1, 7),
                                               (2, 0, 9), (2, 300, 20)])
def test_mrope_positions_bit_for_bit(batch, s_vis, s_txt):
    ours = tsyn._mrope_positions(batch, s_vis, s_txt)
    theirs = np.asarray(jsyn._mrope_positions(batch, s_vis, s_txt))
    assert ours.dtype == torch.int32 and str(theirs.dtype) == "int32"
    np.testing.assert_array_equal(ours.numpy(), theirs)


def _tree(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def _to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(ours, theirs, rtol=1e-6, atol=1e-7):
    for k in theirs:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    rng = np.random.default_rng(0)
    p, m = _tree(rng), _tree(rng)
    pt, mt = _to_torch(p), _to_torch(m)
    for step in range(3):
        g = _tree(rng)
        p, m = jsolvers.sgd(p, g, 0.1, m if momentum else None, momentum)
        pt, mt = tsolvers.sgd(pt, _to_torch(g), 0.1, mt if momentum else None, momentum)
        _close(pt, p)
        if momentum:
            _close(mt, m)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_jax(weight_decay):
    rng = np.random.default_rng(1)
    p = _tree(rng)
    st = jsolvers.adam_init(p)
    pt = _to_torch(p)
    stt = tsolvers.adam_init(pt)
    assert stt.count == 0 and all(float(x.abs().max()) == 0 for x in tree_leaves(stt.mu))
    for _ in range(5):
        g = _tree(rng)
        p, st = jsolvers.adam_update(p, g, st, lr=0.05, weight_decay=weight_decay)
        pt, stt = tsolvers.adam_update(pt, _to_torch(g), stt, lr=0.05,
                                       weight_decay=weight_decay)
        _close(pt, p, rtol=2e-6, atol=2e-7)
        _close(stt.mu, st.mu)
        _close(stt.nu, st.nu)
        assert stt.count == int(st.count)


def test_sgd_and_adam_descend_quadratic():
    loss = lambda p: ((p - 3.0) ** 2).sum()
    p = torch.zeros(5)
    for _ in range(50):
        p, _ = tsolvers.sgd(p, 2 * (p - 3.0), lr=0.1)
    assert float(loss(p)) < 1e-6
    p = torch.zeros(5)
    st = tsolvers.adam_init(p)
    for _ in range(300):
        p, st = tsolvers.adam_update(p, 2 * (p - 3.0), st, lr=0.1)
    assert float(loss(p)) < 1e-4


def test_jax_reference_shapes_agree():
    """agent_batches' layout equals the JAX package's (shapes and dtypes)."""
    cfg, cfg_j = smoke_variant(ARCHS["stablelm-1.6b"]), jax_smoke(JAX_ARCHS["stablelm-1.6b"])
    ours = tsyn.agent_batches(cfg, 2, 3, 16, round_idx=2, seed=5, device="cpu")
    theirs = jsyn.agent_batches(cfg_j, 2, 3, 16, round_idx=2, seed=5)
    assert set(ours) == set(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape
        assert str(ours[k].dtype).split(".")[-1] == str(jnp.asarray(theirs[k]).dtype)
