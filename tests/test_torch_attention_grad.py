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
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.attention import attention_chunked, attention_xla
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref

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
    per call, two calls equal bit for bit, and FlashAttention's backward
    on it (float32 within 1e-4, bf16 within one rounding of the
    gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for name, sq, sk, h, hkv, d, window, softcap, qo, ko in CASES:
        q, k, v, do = (torch.from_numpy(a).cuda().to(dtype)
                       for a in _inputs(sq, sk, h, hkv, d, 4))
        qp = torch.arange(sq, dtype=torch.int32, device="cuda") + qo
        kp = torch.arange(sk, dtype=torch.int32, device="cuda") + ko
        before = ops.launch_counts()["flash_attention_bwd"]
        got = tfa.flash_attention_bwd(q, k, v, do, qp, kp, window=window, softcap=softcap)
        assert ops.launch_counts()["flash_attention_bwd"] == before + 1
        again = tfa.flash_attention_bwd(q, k, v, do, qp, kp, window=window, softcap=softcap)
        want = ref.flash_attention_bwd_ref(q, k, v, do, qp, kp, window=window,
                                           softcap=softcap)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
