"""The port's erasure mask against the JAX package's Pallas kernel.

On the CPU ``repro_torch.kernels.erasure_mask`` runs its plain version
(``repro_torch.kernels.ref.erasure_mask_ref``); the JAX kernel runs in
interpret mode, as the JAX package's own tests run it, and its plain jnp
reference beside it.  Words are made with numpy from a seed and handed to
both.  The grid is ``chip_smoke.py``'s kernel phase at small sizes: p in
{0, 0.1, 0.25, 1}, seeds {0, 7, 2**32 + 5}, ``segment_words`` in
{1, 32, 100}, one size inside a tile and one ragged size over several.

Tolerance: none.  Masked words and keep masks are compared word for word:
the counter hash is integer arithmetic modulo 2**32 on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import erasure_mask as jem
from repro.kernels import ref as jref
from repro_torch.kernels import erasure_mask as tem
from repro_torch.kernels import ops, ref

PS = (0.0, 0.1, 0.25, 1.0)
SEEDS = (0, 7, 2**32 + 5)
SEGMENTS = (1, 32, 100)
SIZES = (2_048, 70_001)


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", PS)
def test_erasure_mask_matches_pallas_word_for_word(p, seed):
    for n in SIZES:
        w = _words(n, seed=n)
        for sw in SEGMENTS:
            masked, keep = ops.erasure_mask(torch.from_numpy(w), p=p, seed=seed,
                                            segment_words=sw)
            mj, kj = jem.erasure_mask(jnp.asarray(w), p=p, seed=seed,
                                      segment_words=sw, interpret=True)
            mr, kr = jref.erasure_mask_ref(jnp.asarray(w), p=p, seed=seed,
                                           segment_words=sw)
            assert masked.dtype == keep.dtype == torch.uint32
            for ours, theirs in ((masked, mj), (keep, kj), (masked, mr), (keep, kr)):
                np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
            kept = keep.numpy().astype(bool)
            np.testing.assert_array_equal(masked.numpy()[kept], w[kept])
            assert not masked.numpy()[~kept].any()
            # a segment is kept or erased as a whole
            seg = np.arange(n) // sw
            first = np.unique(seg, return_index=True)[1]
            np.testing.assert_array_equal(kept, kept[first][seg])


def test_erasure_rate_and_the_edges():
    w = torch.from_numpy(_words(2**16, seed=1))
    assert ops.erasure_mask(w, p=0.0)[1].numpy().all()
    # at p=1 the threshold is 0xFFFFFFFF: a hash equal to it survives
    assert tem.drop_threshold(1.0) == jem.drop_threshold(1.0) == 0xFFFFFFFF
    assert tem.drop_threshold(0.1) == jem.drop_threshold(0.1)
    keep = ops.erasure_mask(w, p=0.25, seed=3, segment_words=1)[1].numpy()
    assert abs(1.0 - keep.mean() - 0.25) < 0.01


def test_segment_hash_matches_jax():
    idx = _words(10_000, seed=4)
    idx[:4] = [0, 1, 2**31, 2**32 - 1]
    for seed in SEEDS + (2**64 - 1,):
        ours = tem.segment_hash(torch.from_numpy(idx), seed).numpy()
        theirs = np.asarray(jem.segment_hash(jnp.asarray(idx), seed))
        np.testing.assert_array_equal(ours, theirs)


def test_two_dimensional_shape_is_kept():
    w = _words(3 * 1_000, seed=5).reshape(3, 1_000)
    masked, keep = ops.erasure_mask(torch.from_numpy(w), p=0.25, seed=7,
                                    segment_words=32)
    mj, kj = jem.erasure_mask(jnp.asarray(w), p=0.25, seed=7, segment_words=32,
                              interpret=True)
    assert masked.shape == keep.shape == (3, 1_000)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(kj))


def test_bad_segment_words_raise_and_cpu_counts_no_launch():
    w = torch.from_numpy(_words(64, seed=6))
    for fn in (ops.erasure_mask, ref.erasure_mask_ref):
        with pytest.raises(ValueError, match="segment_words"):
            fn(w, p=0.1, segment_words=0)
    before = ops.launch_counts()
    ops.erasure_mask(w, p=0.1)
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_cuda_erasure_mask_matches_plain():
    """The CUDA kernel against its plain version on the card: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for n in SIZES:
        w = torch.from_numpy(_words(n, seed=n)).cuda()
        for p in PS:
            for seed in SEEDS:
                for sw in SEGMENTS:
                    got = tem.erasure_mask(w, p=p, seed=seed, segment_words=sw)
                    want = ref.erasure_mask_ref(w, p=p, seed=seed, segment_words=sw)
                    for a, b in zip(got, want):
                        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
