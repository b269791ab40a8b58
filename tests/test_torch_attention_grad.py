"""Attention's gradient in the port: ``flash_attention_bwd_ref`` (the plain
backward, written out) and ``FlashAttention``'s backward, against torch
autograd through the plain forward ``flash_attention_ref`` and against
``jax.grad`` of the JAX package's ``flash_attention_ref``,
``attention_xla`` and ``attention_chunked``.

Float32 on the CPU, unit-scale inputs from numpy; each gradient within
atol 1e-5 (they compute the same sums in other orders).  The JAX
package's reference takes arange positions and one KV head per query
head (GQA goes through ``jnp.repeat``).  Its chunked attention visits no
key when S is below its chunk, picks key chunks by index (queries and
keys aligned) and averages V over the visited chunks only for a row that
sees no key, so it is held on aligned positions, S of at least one chunk
and rows that see keys (ROADMAP Queue 3).  Offset positions and rows
that see no key (the mean of V over all keys, which the kernels keep)
are held against ``attention_xla`` and the plain forward's autograd.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.attention import (_mask_value, _repeat_kv, _softcap, attention_chunked,
                                    attention_xla)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

ATOL = 1e-5

# (name, Sq, Sk, H, Hkv, D, window, softcap, q offset, k offset)
CASES = [
    ("causal", 70, 70, 4, 4, 16, None, None, 0, 0),
    ("window", 70, 70, 4, 4, 16, 20, None, 0, 0),
    ("softcap", 70, 70, 4, 4, 16, None, 5.0, 0, 0),
    ("gqa", 70, 70, 8, 2, 16, None, None, 0, 0),
    ("gqa-window-softcap", 130, 130, 4, 2, 32, 33, 3.0, 0, 0),
    ("positions", 50, 80, 4, 2, 8, None, None, 130, 100),
    ("no-key-rows", 60, 60, 4, 2, 8, None, 5.0, 0, 40),
    ("no-key-window", 60, 60, 2, 1, 8, 10, None, 0, 40),
]
IDS = [c[0] for c in CASES]


def _inputs(sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    return arr(2, sq, h, d), arr(2, sk, hkv, d), arr(2, sk, hkv, d), arr(2, sq, h, d)


def _autograd_plain(q, k, v, do, qp, kp, window, softcap):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ref.flash_attention_ref(qt, kt, vt, qp, kp, window=window, softcap=softcap)
    return torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))


@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", CASES, ids=IDS)
def test_bwd_ref_and_function_match_autograd(name, sq, sk, h, hkv, d, window, softcap,
                                             qo, ko):
    """The written-out backward and FlashAttention.apply's backward (which
    takes it on the CPU) against autograd through the plain forward."""
    q, k, v, do = _inputs(sq, sk, h, hkv, d, IDS.index(name))
    qp = torch.arange(sq, dtype=torch.int32) + qo
    kp = torch.arange(sk, dtype=torch.int32) + ko
    want = _autograd_plain(q, k, v, do, qp, kp, window, softcap)
    got = tfa.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)), qp, kp,
                                  window=window, softcap=softcap)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.attention(qt, kt, vt, window=window, softcap=softcap, q_pos=qp, k_pos=kp)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    through = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for w, g, t in zip(want, got, through):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)
        torch.testing.assert_close(t, g, rtol=0, atol=0)
    if name.startswith("no-key"):
        assert float(got[0][:, :40].abs().max()) == 0.0      # no dq for those rows


ALIGNED = [c for c in CASES if c[1] == c[2] and c[8] == c[9]]


def _jax_grads(f, q, k, v, do):
    return jax.jit(jax.grad(lambda q, k, v: jnp.vdot(f(q, k, v), do),
                            argnums=(0, 1, 2)))(q, k, v)


def _check_against(gj, q, k, v, do, qp, kp, window, softcap):
    got = tfa.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)), qp, kp,
                                  window=window, softcap=softcap)
    for g, w in zip(got, gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", ALIGNED,
                         ids=[c[0] for c in ALIGNED])
def test_bwd_matches_jax_grad_of_reference(name, sq, sk, h, hkv, d, window, softcap, qo,
                                           ko):
    """Against jax.grad of repro.kernels.ref.flash_attention_ref, the
    function of the Pallas kernel (arange positions; GQA by jnp.repeat,
    whose gradient sums each group)."""
    q, k, v, do = _inputs(sq, sk, h, hkv, d, 1 + IDS.index(name))
    rep = lambda t: jnp.repeat(t, h // hkv, axis=2)
    gj = _jax_grads(lambda q, k, v: jax_flash_ref(q, rep(k), rep(v), causal=True,
                                                  window=window, softcap=softcap),
                    q, k, v, do)
    ar = lambda n: torch.arange(n, dtype=torch.int32)
    _check_against(gj, q, k, v, do, ar(sq), ar(sk), window, softcap)


@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", CASES, ids=IDS)
def test_bwd_matches_jax_grad_of_attention_xla(name, sq, sk, h, hkv, d, window, softcap,
                                               qo, ko):
    """Against jax.grad of repro.models.attention.attention_xla, which takes
    explicit positions and GQA: offsets and rows that see no key (their
    softmax is uniform over every key, as in the kernels)."""
    q, k, v, do = _inputs(sq, sk, h, hkv, d, 2 + IDS.index(name))
    qp, kp = np.arange(sq, dtype=np.int32) + qo, np.arange(sk, dtype=np.int32) + ko
    gj = _jax_grads(lambda q, k, v: attention_xla(q, k, v, qp, kp, window=window,
                                                  softcap=softcap), q, k, v, do)
    _check_against(gj, q, k, v, do, torch.from_numpy(qp), torch.from_numpy(kp), window,
                   softcap)


@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", ALIGNED,
                         ids=[c[0] for c in ALIGNED])
def test_bwd_matches_jax_grad_of_attention_chunked(name, sq, sk, h, hkv, d, window,
                                                   softcap, qo, ko):
    """Against jax.grad of repro.models.attention.attention_chunked (the JAX
    model's training attention, differentiated by XLA) with chunks of 32,
    below every S here, and positions offset by 7."""
    q, k, v, do = _inputs(sq, sk, h, hkv, d, 3 + IDS.index(name))
    pos = np.arange(sq, dtype=np.int32) + 7
    gj = _jax_grads(lambda q, k, v: attention_chunked(
        q, k, v, pos, pos, window=window, softcap=softcap, chunk_q=32, chunk_k=32),
        q, k, v, do)
    _check_against(gj, q, k, v, do, torch.from_numpy(pos), torch.from_numpy(pos), window,
                   softcap)


# (name, q_pos, k_pos, causal, window)
PLAN_CASES = [
    ("aligned", np.arange(300), np.arange(300), True, None),
    ("window", np.arange(2048), np.arange(2048), True, 64),
    ("offset", np.arange(200, 300) + 100, np.arange(300) + 100, True, 64),
    ("keys-ahead", np.arange(385), np.arange(192, 577), True, None),
    ("non-causal-window", np.arange(400), np.arange(400), False, 100),
]


@pytest.mark.parametrize("name,q_pos,k_pos,causal,window", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_bwd_tile_plan_skips_only_hidden_tiles(name, q_pos, k_pos, causal, window):
    """The backward kernel's rule at its 64 x 64 tiles: a pair of tiles it
    skips holds no visible pair, and for consecutive positions every tile
    with a visible pair is visited."""
    qp, kp = torch.from_numpy(q_pos).int(), torch.from_numpy(k_pos).int()
    bq, bk = tfa.BWD_BLOCK_Q, tfa.BWD_BLOCK_K
    plan = tfa.tile_plan(qp, kp, causal=causal, window=window, block_q=bq, block_k=bk)
    mask = ref.attention_mask(qp, kp, causal=causal, window=window)
    assert plan.shape == (-(-len(q_pos) // bq), -(-len(k_pos) // bk))
    for qt in range(plan.shape[0]):
        for kt in range(plan.shape[1]):
            block = mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
            assert (int(plan[qt, kt]) != tfa.SKIP) == bool(block.any()), (qt, kt)


def test_training_shape_visits_the_causal_band():
    """At the training path's shape (S = 2048, causal) the backward visits
    528 of the 1024 pairs of tiles, the causal band's."""
    pos = torch.arange(2048, dtype=torch.int32)
    plan = tfa.tile_plan(pos, pos, causal=True, block_q=tfa.BWD_BLOCK_Q,
                         block_k=tfa.BWD_BLOCK_K)
    assert int((plan != tfa.SKIP).sum()) == 32 * 33 // 2


@pytest.mark.parametrize("name,q_pos,k_pos,causal,window", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_f32_bwd_kv_tile_plan_skips_only_hidden_tiles(name, q_pos, k_pos, causal, window):
    """The float32 backward's dK/dV grid at its tiles (BWD_KV_BLOCK_Q query
    rows by BWD_BLOCK_K keys): a skipped pair of tiles holds no visible
    pair, every pair with one is visited, and a FULL pair is visible
    throughout."""
    qp, kp = torch.from_numpy(q_pos).int(), torch.from_numpy(k_pos).int()
    bq, bk = tfa.BWD_KV_BLOCK_Q, tfa.BWD_BLOCK_K
    plan = tfa.tile_plan(qp, kp, causal=causal, window=window, block_q=bq, block_k=bk)
    mask = ref.attention_mask(qp, kp, causal=causal, window=window)
    assert plan.shape == (-(-len(q_pos) // bq), -(-len(k_pos) // bk))
    for qt in range(plan.shape[0]):
        for kt in range(plan.shape[1]):
            block = mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
            assert (int(plan[qt, kt]) != tfa.SKIP) == bool(block.any()), (qt, kt)
            if int(plan[qt, kt]) == tfa.FULL:
                assert bool(block.all()) and block.shape[1] == bk, (qt, kt)


def test_f32_bwd_shared_memory_fits_at_every_head_dim():
    """The float32 backward's two grids at every D <= 128: within the 227
    KB a block may take, two blocks to an SM at D <= 64 (each with the 1 KB
    the card reserves a block), and the parts of its layout: rows of D
    rounded up to 64 or 128 floats plus 4."""
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        dkdv, dq = tfa.f32_bwd_smem_bytes(d)
        assert max(dkdv, dq) <= tfa.SMEM_LIMIT, d
        if d <= 64:
            assert 2 * (max(dkdv, dq) + 1024) <= 233_472, d
        assert tfa.f32_bwd_smem_bytes(d) == tfa.f32_bwd_smem_bytes(64 if d <= 64 else 128)
    # K, V; the Q and dO ring; its LSE and D rows; the no-key sum.  Q, dO;
    # the K, V ring
    assert tfa.f32_bwd_smem_bytes(64) == (
        4 * (2 * 64 * 68 + 2 * 2 * 32 * 68 + 2 * 2 * 32 + 64),
        4 * (2 * 64 * 68 + 2 * 2 * 64 * 68))
    assert tfa.f32_bwd_smem_bytes(128) == (
        4 * (2 * 64 * 132 + 2 * 2 * 32 * 132 + 2 * 2 * 32 + 128),
        4 * (2 * 64 * 132 + 2 * 2 * 64 * 132))


# the catalog's groups (stablelm 32/32, gemma3 32/16, qwen2-vl 28/4, 8 query
# heads per KV head, granite's MQA 48/1) at the training shape's S and at
# ragged ones (S = 2100: a group of 8 no longer fits 512 tiles; S = 40000:
# one head is longer than the chain)
@pytest.mark.parametrize("sq", [2048, 2100, 40000])
@pytest.mark.parametrize("n_rep", [1, 2, 7, 8, 48])
def test_f32_bwd_head_slices_visit_every_head_and_tile_once(n_rep, sq):
    """The float32 backward's dK/dV split: the blocks of one (batch row,
    KV head, key tile) take contiguous runs of the group's heads, in head
    order, so that every (head, query tile) is walked by exactly one block;
    no block's chain is longer than BWD_CHAIN_TILES query tiles unless one
    head is; and there are as few blocks as that allows, evenly loaded.
    At S = 2048 only granite's 48 heads split, into 6 blocks of 8."""
    slices = tfa.f32_bwd_head_slices(n_rep, sq)
    n_qt = -(-sq // tfa.BWD_KV_BLOCK_Q)
    assert slices[0][0] == 0 and slices[-1][1] == n_rep
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    walked = [(h, qt) for lo, hi in slices for h in range(lo, hi) for qt in range(n_qt)]
    assert walked == [(h, qt) for h in range(n_rep) for qt in range(n_qt)]
    chains = [(hi - lo) * n_qt for lo, hi in slices]
    assert min(chains) > 0 and max(chains) <= max(tfa.BWD_CHAIN_TILES, n_qt)
    per = max(1, tfa.BWD_CHAIN_TILES // n_qt)      # most heads a chain may take
    assert len(slices) == -(-n_rep // per)
    assert max(hi - lo for lo, hi in slices) - min(hi - lo for lo, hi in slices) <= 1
    if sq == 2048:
        assert slices == ([(0, n_rep)] if n_rep <= 8 else
                          [(8 * g, 8 * g + 8) for g in range(6)])


@pytest.mark.parametrize("b,sq,sk,h,hkv,d", [
    (2, 2048, 2048, 32, 32, 64),        # stablelm-1.6b: one block per key tile
    (2, 2048, 2048, 28, 4, 128),        # qwen2-vl-7b
    (2, 2048, 2048, 48, 1, 128),        # granite-20b: 6 slices
    (1, 2100, 2300, 16, 2, 33),         # ragged S and D: 8 heads over 2 slices
    (1, 300, 300, 4, 4, 8),
], ids=["stablelm", "qwen2-vl", "granite", "ragged", "small"])
def test_f32_bwd_allocates_partials_only_for_a_split(b, sq, sk, h, hkv, d):
    """The float32 wrapper's scratch for a split chain: (slices, B, Sk, Hkv,
    D) float32, one each for dK and dV, only when f32_bwd_head_slices gives
    a group several blocks; the launch gets the slice count the kernel
    checks against its own rule.  The wrapper runs on meta tensors (shapes
    only: the launch is handed to _build.meta_hook, nothing runs)."""
    from repro_torch.kernels import _build
    n = len(tfa.f32_bwd_head_slices(h // hkv, sq))
    want = (n, b, sk, hkv, d) if n > 1 else None
    assert tfa.f32_bwd_partials_shape((b, sq, h, d), (b, sk, hkv, d)) == want
    meta = dict(dtype=torch.float32, device="meta")
    q, do = torch.empty((b, sq, h, d), **meta), torch.empty((b, sq, h, d), **meta)
    k, v = torch.empty((b, sk, hkv, d), **meta), torch.empty((b, sk, hkv, d), **meta)
    lse = torch.empty((b, h, -(-sq // tfa.BLOCK_Q) * tfa.BLOCK_Q), **meta)
    seen = []
    hook, _build.meta_hook = _build.meta_hook, lambda name, args: seen.append((name, args))
    try:
        dq, dk, dv = tfa.flash_attention_bwd(q, k, v, do, stats=(lse, q))
    finally:
        _build.meta_hook = hook
    assert [name for name, _ in seen] == ["flash_attention_bwd"]
    *_, n_split, dk_part, dv_part = seen[0][1]
    assert n_split == n and dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if want is None:
        assert dk_part is None and dv_part is None
    else:
        assert all(t.shape == want and t.dtype == torch.float32 for t in (dk_part, dv_part))
        assert dk_part is not dv_part


@pytest.mark.parametrize("bq", [tfa.sm90_bwd_block_q(64), tfa.sm90_bwd_block_q(128)])
@pytest.mark.parametrize("name,q_pos,k_pos,causal,window", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_sm90_bwd_tile_plan_skips_only_hidden_tiles(name, q_pos, k_pos, causal, window,
                                                    bq):
    """The bf16 backward's rule at its tiles: query tiles of
    sm90_bwd_block_q(D) rows (64, or 32 for D > 64) by SM90_BWD_BLOCK keys
    in the dK/dV grid, SM90_BWD_BLOCK by SM90_BWD_BLOCK in the dQ grid.
    A skipped pair of tiles holds no visible pair, every pair with one is
    visited, and a FULL pair is visible throughout."""
    qp, kp = torch.from_numpy(q_pos).int(), torch.from_numpy(k_pos).int()
    bk = tfa.SM90_BWD_BLOCK
    plan = tfa.tile_plan(qp, kp, causal=causal, window=window, block_q=bq, block_k=bk)
    mask = ref.attention_mask(qp, kp, causal=causal, window=window)
    assert plan.shape == (-(-len(q_pos) // bq), -(-len(k_pos) // bk))
    for qt in range(plan.shape[0]):
        for kt in range(plan.shape[1]):
            block = mask[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
            assert (int(plan[qt, kt]) != tfa.SKIP) == bool(block.any()), (qt, kt)
            if int(plan[qt, kt]) == tfa.FULL:
                assert bool(block.all()) and block.shape[1] == bk, (qt, kt)


def test_sm90_training_shape_visits_the_causal_band():
    """At the training path's shape (S = 2048, D = 64, causal) both grids of
    the bf16 backward visit the causal band's 528 of 1024 pairs of 64 x 64
    tiles, 32 of them on the diagonal with the mask."""
    pos = torch.arange(2048, dtype=torch.int32)
    blk = tfa.SM90_BWD_BLOCK
    plan = tfa.tile_plan(pos, pos, causal=True, block_q=tfa.sm90_bwd_block_q(64),
                         block_k=blk)
    assert tfa.sm90_bwd_block_q(64) == blk == 64
    assert int((plan != tfa.SKIP).sum()) == 32 * 33 // 2
    assert int((plan == tfa.MASKED).sum()) == 32


def test_sm90_bwd_shared_memory_fits_at_every_head_dim():
    """The bf16 backward's two grids at every D <= 128 at the training
    shape's plans (S = 2048): within the 227 KB a block may take, and two
    blocks to an SM (each with the 1 KB the card reserves a block) within
    the SM's 228 KB; D = 64 and 128 by their parts."""
    for d in range(1, tfa.MAX_HEAD_DIM + 1):
        dkdv, dq = tfa.sm90_bwd_smem_bytes(d, 2048, 2048)
        assert max(dkdv, dq) <= tfa.SMEM_LIMIT, d
        assert 2 * (max(dkdv, dq) + 1024) <= 233_472, d
    plan = lambda n: -(-n // 16) * 16
    # K, V; the Q and dO rings; their LSE and D rows; barriers, no-key sum,
    # plan; and for dQ: Q, dO; the K, V ring; barriers, plan
    assert tfa.sm90_bwd_smem_bytes(64, 2048, 2048) == (
        2 * 8192 + 2 * 2 * 8192 + 2 * 2 * 64 * 4 + 40 + 512 + plan(32) + 1024,
        2 * 8192 + 2 * 2 * 8192 + 40 + plan(32) + 1024)
    assert tfa.sm90_bwd_smem_bytes(128, 2048, 2048) == (
        2 * 16384 + 2 * 2 * 8192 + 2 * 2 * 32 * 4 + 40 + 512 + plan(64) + 1024,
        2 * 16384 + 2 * 2 * 16384 + 40 + plan(32) + 1024)
    assert all(tfa.sm90_bwd_smem_bytes(d, 700, 900) == tfa.sm90_bwd_smem_bytes(
        -(-d // 8) * 8, 700, 900) for d in range(1, 129))
    assert max(tfa.sm90_bwd_smem_bytes(128, 2**23, 2**23)) > tfa.SMEM_LIMIT


# -- the forward's statistics (the bf16 backward reads them) -----------------

@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", CASES, ids=IDS)
def test_plain_forward_lse_is_logsumexp_of_jax_scores(name, sq, sk, h, hkv, d, window,
                                                      softcap, qo, ko):
    """The plain forward's saved log-sum-exp, in log2 units, times ln 2
    equals jax.nn.logsumexp of the JAX package's masked scores
    (attention_xla's: q·k/√D, softcap, the −1e30 mask) on rows that see a
    key, and is +inf on rows that see none; its O in float32 is the output
    before the cast."""
    q, k, v, _ = _inputs(sq, sk, h, hkv, d, 20 + IDS.index(name))
    qp, kp = np.arange(sq, dtype=np.int32) + qo, np.arange(sk, dtype=np.int32) + ko
    n_rep = h // hkv
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, _repeat_kv(jnp.asarray(k), n_rep))
    scores = _mask_value(_softcap(scores / np.sqrt(d), softcap), qp, kp, window)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    out, lse, o = ref.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(qp),
        torch.from_numpy(kp), window=window, softcap=softcap, stats=True)
    seen = (kp[None, :] <= qp[:, None])
    if window is not None:
        seen &= kp[None, :] > qp[:, None] - window
    seen = seen.any(axis=1)
    assert lse.shape == (2, h, sq) and lse.dtype == torch.float32
    got = lse.numpy() * np.log(2.0)
    np.testing.assert_allclose(got[..., seen], want[..., seen], rtol=0, atol=1e-5)
    assert np.isposinf(lse.numpy()[..., ~seen]).all() and (~seen).any() == name.startswith(
        "no-key")
    assert o.dtype == torch.float32 and torch.equal(o.to(out.dtype), out)


@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", CASES, ids=IDS)
def test_bwd_ref_with_saved_stats_equals_recomputing(name, sq, sk, h, hkv, d, window,
                                                     softcap, qo, ko):
    """flash_attention_bwd_ref on the forward's saved (LSE, O) equals the
    version that recomputes them within 1e-6 (relative, and absolute near
    0: P = 2**(s·log2(e) − LSE) and exp(s − m)/l part by a few float32
    ulps), rows that see no key included (their dO/Sk in every dV,
    nothing in dQ or dK)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(sq, sk, h, hkv, d,
                                                        30 + IDS.index(name)))
    qp = torch.arange(sq, dtype=torch.int32) + qo
    kp = torch.arange(sk, dtype=torch.int32) + ko
    kw = dict(window=window, softcap=softcap)
    _, lse, o = ref.flash_attention_ref(q, k, v, qp, kp, stats=True, **kw)
    saved = ref.flash_attention_bwd_ref(q, k, v, do, qp, kp, stats=(lse, o), **kw)
    recomputed = ref.flash_attention_bwd_ref(q, k, v, do, qp, kp, **kw)
    for g, w in zip(saved, recomputed):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,sq,sk,h,hkv,d,window,softcap,qo,ko", CASES, ids=IDS)
def test_bwd_ref_reads_the_first_sq_rows_of_a_padded_lse(name, sq, sk, h, hkv, d, window,
                                                         softcap, qo, ko):
    """The bf16 forward hands the backward its log-sum-exp padded to a
    multiple of BLOCK_Q rows with +inf past Sq; flash_attention_bwd_ref
    given that padded LSE returns the bits it returns on the plain
    forward's (B, H, Sq) one."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(sq, sk, h, hkv, d,
                                                        40 + IDS.index(name)))
    qp = torch.arange(sq, dtype=torch.int32) + qo
    kp = torch.arange(sk, dtype=torch.int32) + ko
    kw = dict(window=window, softcap=softcap)
    _, lse, o = ref.flash_attention_ref(q, k, v, qp, kp, stats=True, **kw)
    rows = -(-sq // tfa.BLOCK_Q) * tfa.BLOCK_Q
    padded = torch.nn.functional.pad(lse, (0, rows - sq), value=math.inf)
    want = ref.flash_attention_bwd_ref(q, k, v, do, qp, kp, stats=(lse, o), **kw)
    got = ref.flash_attention_bwd_ref(q, k, v, do, qp, kp, stats=(padded, o), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _saved_by_function(q, k, v, recording: bool):
    """Run FlashAttention on the CPU and return the shapes of the tensors
    autograd saved and the ``stats`` flags the forward was called with."""
    flags, saved = [], []
    forward = tfa._forward

    def spy(*args, **kw):
        flags.append(kw.get("stats", False))
        return forward(*args, **kw)

    tfa._forward = spy
    try:
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            with torch.set_grad_enabled(recording):
                tfa.flash_attention(q, k, v, window=16)
    finally:
        tfa._forward = forward
    return flags, saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_function_saves_stats_only_when_autograd_records(dtype):
    """With grad enabled and an input that needs it, FlashAttention asks
    the forward for (LSE, O) and saves them beside q, k, v and the
    positions, on both routes (the float32 one too: its backward kernel
    reads them); under torch.no_grad(), or with no input that needs grad,
    the forward computes no statistics and nothing is saved."""
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in _inputs(40, 40, 4, 2, 8, 11))
    qg = q.clone().requires_grad_()
    flags, saved = _saved_by_function(qg, k, v, recording=True)
    assert flags == [True]
    assert saved == [(2, 40, 4, 8), (2, 40, 2, 8), (2, 40, 2, 8), (40,), (40,),
                     (2, 4, 40), (2, 40, 4, 8)]
    assert _saved_by_function(qg, k, v, recording=False) == ([False], [])
    assert _saved_by_function(q, k, v, recording=True) == ([False], [])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_remat_writes_stats_in_both_passes_and_reads_the_recompute(dtype):
    """Under torch.utils.checkpoint(use_reentrant=False), as the model's
    remat runs each layer, the first pass records with grad enabled too:
    both it and the backward's recompute ask the forward for (LSE, O), in
    either dtype.  The first pass's copy is dropped by checkpoint's
    saved-tensor hook; the backward reads the recompute's, and its
    gradient equals the gradient taken without remat."""
    from torch.utils.checkpoint import checkpoint
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(40, 40, 4, 2, 8, 12))
    flags, forward = [], tfa._forward

    def spy(*args, **kw):
        flags.append(kw.get("stats", False))
        return forward(*args, **kw)

    def run(q, k, v):
        return tfa.flash_attention(q, k, v, window=16)

    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flags.clear()
        tfa._forward = spy
        try:
            out = checkpoint(run, *leaves, use_reentrant=False) if remat else run(*leaves)
            grads.append(torch.autograd.grad(out, leaves, do))
        finally:
            tfa._forward = forward
        assert flags == ([True, True] if remat else [True])
    for g, w in zip(*grads):
        assert torch.equal(g, w)


# -- the bf16 kernel's operand rounding --------------------------------------

def _emulate_bwd_sm90(q, k, v, do, q_pos, k_pos, *, split_p: bool, split_ds: bool,
                      window=None, softcap=None):
    """flash_attention_bwd_sm90's arithmetic on the CPU: bf16 Q, K, V and
    dO, products exact and summed in float32 (as wgmma sums them), P and
    dS from the forward's saved (LSE, O), each either as hi + lo in bf16
    or rounded once, and each gradient rounded to bf16 once."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    _, lse, o = ref.flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                        softcap=softcap, stats=True)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kf, vf = (t.repeat_interleave(n_rep, dim=2) for t in (kf, vf))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / np.sqrt(d)
    chain = 1.0
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, chain = softcap * t, 1.0 - t * t
    ok = ref.attention_mask(q_pos, k_pos, causal=True, window=window)
    p = torch.exp2(s * ref.LOG2E - lse[..., None]).masked_fill(~ok, 0.0)
    delta = (dof * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta) * chain

    def operand(x, split):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dv = sum(torch.einsum("bhqk,bqhd->bkhd", t, dof) for t in operand(p, split_p))
    dk = sum(torch.einsum("bhqk,bqhd->bkhd", t, qf) for t in operand(ds, split_ds))
    dq = sum(torch.einsum("bhqk,bkhd->bqhd", t, kf) for t in operand(ds, split_ds))
    group = lambda t: t.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    none = ~ok.any(dim=-1)
    dv_none = (dof[:, none].sum(1) / sk).reshape(b, hkv, n_rep, d).sum(2)
    return ((dq / np.sqrt(d)).to(torch.bfloat16),
            group(dk / np.sqrt(d)).to(torch.bfloat16),
            (group(dv) + dv_none[:, None]).to(torch.bfloat16))


def _bwd_out_of_limit(got, plain) -> list:
    """Elements of (dq, dk, dv) outside the bf16 check's limit,
    |kernel − plain| <= 2**-7·|plain| + 1e-3."""
    return [int(((g.float() - w.float()).abs() > 1e-3 + 2**-7 * w.float().abs()).sum())
            for g, w in zip(got, plain)]


@pytest.mark.parametrize("s,d,h,hkv,window,softcap",
                         [(128, 64, 4, 4, None, None), (257, 64, 4, 4, 64, 30.0),
                          (257, 128, 4, 2, None, None), (200, 120, 4, 2, None, 30.0)])
def test_split_p_and_ds_keep_the_gradient_within_one_rounding(s, d, h, hkv, window,
                                                               softcap):
    """The bf16 backward's operands: with P and dS each as P_hi + P_lo in
    bf16 the gradient stays within one bf16 rounding of the plain
    version's, |kernel − plain| <= 2**-7·|plain| + 1e-3 (the card's check);
    with P rounded once to bf16 dV leaves it, and with dS rounded once dQ
    or dK does."""
    rng = np.random.default_rng(s + d + h)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        torch.bfloat16)
    q, k, v, do = arr(2, s, h, d), arr(2, s, hkv, d), arr(2, s, hkv, d), arr(2, s, h, d)
    pos = torch.arange(s, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    plain = ref.flash_attention_bwd_ref(q, k, v, do, pos, pos, **kw)
    emulate = lambda sp, sd: _bwd_out_of_limit(
        _emulate_bwd_sm90(q, k, v, do, pos, pos, split_p=sp, split_ds=sd, **kw), plain)
    assert emulate(True, True) == [0, 0, 0]
    assert emulate(False, True)[2] > 0
    out = emulate(True, False)
    assert out[2] == 0 and out[0] + out[1] > 0


# -- the float32 kernel's arithmetic: three TF32 products per product -------

def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 of finite float32 values: 10 bits of mantissa, to
    nearest with ties away from zero; add half of the last kept bit to the
    magnitude and clear the 13 bits below it (the sign bit is apart, so
    the carry rounds the magnitude up; a carry out of the mantissa raises
    the exponent).  The CUDA kernel computes it the same way."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


# (input bits, cvt.rna.tf32.f32 bits)
TF32_CASES = [
    (0x3F800000, 0x3F800000),   # 1.0: kept
    (0x3F800FFF, 0x3F800000),   # just below half of the last kept bit: down
    (0x3F801000, 0x3F802000),   # a tie: away from zero
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0x3F803000, 0x3F804000),   # a tie above an odd kept bit: away, not to even
    (0x3F801001, 0x3F802000),   # just above half: up
    (0x3FFFF000, 0x40000000),   # 1.99951...: the carry raises the exponent
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x80000000, 0x80000000),   # -0.0
]


@pytest.mark.parametrize("x,want", TF32_CASES, ids=[f"{x:08x}" for x, _ in TF32_CASES])
def test_tf32_rna_model_on_hand_picked_bits(x, want):
    got = _tf32_rna(np.array([x], dtype=np.uint32).view(np.float32))
    assert int(got.view(np.uint32)[0]) == want


def test_tf32_rna_keeps_ten_bits_within_half_an_ulp():
    """On many values: the low 13 bits are zero, the error is at most half
    of 2**-10 of the value's binade, and x - hi is exact in float32, so
    hi + lo splits x with lo's own rounding the only loss."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-6, 6, 100_000)).astype(np.float32)
    hi = _tf32_rna(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    ulp = np.ldexp(np.float32(1.0), np.frexp(x)[1] - 11).astype(np.float32)
    assert (np.abs(x.astype(np.float64) - hi) <= ulp / 2).all()
    rest = x - hi
    assert (rest.astype(np.float64) == x.astype(np.float64) - hi.astype(np.float64)).all()
    lo = _tf32_rna(rest)
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()


def _tf32_terms(a: torch.Tensor, terms: int):
    """a as TF32 parts for ``terms`` products: (hi, lo) when each product
    takes the small terms, else (hi,)."""
    hi = torch.from_numpy(_tf32_rna(a.numpy()))
    return hi, torch.from_numpy(_tf32_rna((a - hi).numpy()))


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """einsum(eq, a, b) as the kernel computes it: a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi (terms=3), the small terms first, each product of TF32
    values exact in float32 and summed in float32; terms=2 drops a_lo·b_hi
    and terms=1 keeps a_hi·b_hi alone (the controls)."""
    (ah, al), (bh, bl) = _tf32_terms(a, terms), _tf32_terms(b, terms)
    parts = {3: [(al, bh), (ah, bl)], 2: [(ah, bl)], 1: []}[terms] + [(ah, bh)]
    out = torch.zeros(())
    for x, y in parts:
        out = out + torch.einsum(eq, x, y)
    return out


def _emulate_bwd_f32(q, k, v, do, q_pos, k_pos, *, terms: int, window=None, softcap=None):
    """flash_attention_bwd.cu's arithmetic on the CPU: P = 2**(s·log2(e) −
    LSE) from the forward's saved LSE, D from its O, and every product (S =
    Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K) in ``terms`` TF32
    products (:func:`_tf32_product`)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    _, lse, o = ref.flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                        softcap=softcap, stats=True)
    kf, vf = (t.repeat_interleave(n_rep, dim=2) for t in (k, v))
    s = _tf32_product("bqhd,bkhd->bhqk", q, kf, terms) / np.sqrt(d)
    chain = 1.0
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, chain = softcap * t, 1.0 - t * t
    ok = ref.attention_mask(q_pos, k_pos, causal=True, window=window)
    p = torch.exp2(s * ref.LOG2E - lse[..., None]).masked_fill(~ok, 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (_tf32_product("bqhd,bkhd->bhqk", do, vf, terms) - delta) * chain
    dv = _tf32_product("bhqk,bqhd->bkhd", p, do, terms)
    dk = _tf32_product("bhqk,bqhd->bkhd", ds, q, terms)
    dq = _tf32_product("bhqk,bkhd->bqhd", ds, kf, terms)
    group = lambda t: t.reshape(b, sk, hkv, n_rep, d).sum(dim=3)
    none = ~ok.any(dim=-1)
    dv_none = (do[:, none].sum(1) / sk).reshape(b, hkv, n_rep, d).sum(2)
    return dq / np.sqrt(d), group(dk / np.sqrt(d)), group(dv) + dv_none[:, None]


# the card's check of the float32 backward against its plain version
# (chip_smoke.py FLASH_BWD_TOL[torch.float32]): |kernel − plain| <= 1e-4
F32_BWD_ATOL = 1e-4


@pytest.mark.parametrize("s,d,h,hkv,window,softcap",
                         [(2048, 16, 2, 1, None, None), (2048, 8, 2, 2, 512, 30.0),
                          (300, 64, 2, 1, 64, 30.0), (257, 120, 2, 2, None, None)])
def test_three_tf32_terms_keep_the_float32_tolerance(s, d, h, hkv, window, softcap):
    """The float32 backward's products as three TF32 products each stay
    within the card's 1e-4 of the plain version's gradient, at S up to
    2048 (narrow heads), with softcap and window cases; with one TF32
    product each (10 bits of mantissa), or two (a's own rounding kept),
    some gradient leaves it."""
    rng = np.random.default_rng(s + d + h)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32))
    q, k, v, do = arr(1, s, h, d), arr(1, s, hkv, d), arr(1, s, hkv, d), arr(1, s, h, d)
    pos = torch.arange(s, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    plain = ref.flash_attention_bwd_ref(q, k, v, do, pos, pos, **kw)
    err = lambda terms: max(float((g - w).abs().max()) for g, w in zip(
        _emulate_bwd_f32(q, k, v, do, pos, pos, terms=terms, **kw), plain))
    assert err(3) <= F32_BWD_ATOL
    assert err(2) > F32_BWD_ATOL
    assert err(1) > F32_BWD_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_keeps_the_inputs_dtype(dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(40, 40, 4, 2, 8, 9))
    got = tfa.flash_attention_bwd(q, k, v, do, window=16, softcap=30.0)
    assert [g.dtype for g in got] == [dtype] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(q, k, v, do[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0.0, 1e-4),
                                             (torch.bfloat16, 2**-7, 1e-3)])
def test_cuda_flash_attention_bwd_matches_plain(dtype, rtol, atol):
    """The CUDA backward against its plain version on the card, one launch
    of the dtype's kernel per call (flash_attention_bwd for float32,
    flash_attention_bwd_sm90 for bf16), two calls equal bit for bit
    (float32 within 1e-4, bf16 within one rounding of the gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    name_bwd = tfa.bwd_route(dtype, "cuda")
    assert name_bwd == {torch.float32: "flash_attention_bwd",
                        torch.bfloat16: "flash_attention_bwd_sm90"}[dtype]
    for name, sq, sk, h, hkv, d, window, softcap, qo, ko in CASES:
        q, k, v, do = (torch.from_numpy(a).cuda().to(dtype)
                       for a in _inputs(sq, sk, h, hkv, d, 4))
        qp = torch.arange(sq, dtype=torch.int32, device="cuda") + qo
        kp = torch.arange(sk, dtype=torch.int32, device="cuda") + ko
        before = ops.launch_counts()[name_bwd]
        got = tfa.flash_attention_bwd(q, k, v, do, qp, kp, window=window, softcap=softcap)
        assert ops.launch_counts()[name_bwd] == before + 1
        again = tfa.flash_attention_bwd(q, k, v, do, qp, kp, window=window, softcap=softcap)
        want = ref.flash_attention_bwd_ref(q, k, v, do, qp, kp, window=window,
                                           softcap=softcap)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_bf16_bwd_sums_a_large_group_in_float32():
    """granite-20b's MQA training shape (B 2, S 2048, 48 query heads on one
    KV head, D 128): the bf16 backward adds its dK and dV accumulators to
    float32 sums every 256 query tiles, so each element stays within one
    rounding of the plain version's and the signed drift toward zero,
    which one wgmma accumulator chain over the 48 heads takes to 1.5e-4 of
    |dK|, stays near a chain of four heads' (2e-5; bench/attention_bwd.py
    measures it by group size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((2, 2048, 48, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((2, 2048, 1, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.arange(2048, dtype=torch.int32, device="cuda")
    got = tfa.flash_attention_bwd(q, k, v, do, pos, pos)
    for i in range(2):
        row = lambda t: t[i:i + 1]
        want = ref.flash_attention_bwd_ref(*(row(t).float() for t in (q, k, v, do)),
                                           pos, pos)
        for g, w in zip(got, want):
            g = row(g).float()
            torch.testing.assert_close(g, w, rtol=2**-7, atol=1e-3)
            assert float(((g - w) * w.sign()).mean() / w.abs().mean()) > -4e-5
