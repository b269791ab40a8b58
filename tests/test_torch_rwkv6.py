"""The port's RWKV-6 block (``repro_torch.models.rwkv6``) against the JAX
package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
JAX side runs under ``jax.jit``.  The chunked WKV is checked at S in {16,
64, 100, 130} (chunk 32) with and without a carried state, and its
gradient; the time-mix and channel-mix (rwkv6-3b's smoke variant: d 256,
4 heads of 64, d_ff 512) through a prefill and three decode steps, the
cache updated in place; the decay clamp in both paths.

Tolerance: float32 rtol 1e-4 / atol 1e-5 against JAX (the packages sum in
different orders); against the port's own step-by-step recurrence
(``naive_wkv``) rtol / atol 5e-4, the reference's own oracle tolerance
(``tests/test_ssm_oracles.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import rwkv6 as jr
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.models import rwkv6 as tr
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE = dict(rtol=5e-4, atol=5e-4)
LENGTHS = [16, 64, 100, 130]


def t(x):
    return torch.from_numpy(np.array(x))


def close(ours, theirs, what: str, **tol) -> float:
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, **(tol or TOL), err_msg=what)
    return float(np.abs(ours - theirs).max())


def naive_wkv(r, k, v, logw, u, state0=None):
    """The recurrence one token at a time, in the port (float32)."""
    b, s, h, p = r.shape
    S = torch.zeros((b, h, p, p)) if state0 is None else state0
    ys = []
    for i in range(s):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        ys.append(torch.einsum("bhp,bhpn->bhn", r[:, i], S + u[None, :, :, None] * kv))
        S = torch.exp(logw[:, i])[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv_inputs(s: int, seed: int, state: bool):
    b, h, p = 2, 2, 8
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    logw = -np.exp(0.5 * f(b, s, h, p) - 2.0)
    inp = dict(r=0.5 * f(b, s, h, p), k=0.5 * f(b, s, h, p), v=0.5 * f(b, s, h, p),
               logw=np.maximum(logw, -80.0 / tr.RWKV_CHUNK).astype(np.float32),
               u=0.3 * f(h, p))
    return inp, (0.5 * f(b, h, p, p) if state else None)


def test_constants_are_the_reference_ones():
    assert (tr.LORA_RANK, tr.RWKV_CHUNK) == (jr.LORA_RANK, jr.RWKV_CHUNK) == (64, 64)


@pytest.mark.parametrize("state", [False, True], ids=["zero_state", "state0"])
@pytest.mark.parametrize("s", LENGTHS)
def test_chunked_wkv_matches_jax_and_the_recurrence(s, state):
    inp, s0 = wkv_inputs(s, seed=s, state=state)
    yj, Sj = jax.jit(lambda i, s0: jr._chunked_wkv(**i, chunk=32, state0=s0))(inp, s0)
    ti = {k: t(v) for k, v in inp.items()}
    s0_t = None if s0 is None else t(s0)
    yt, St = tr._chunked_wkv(**ti, chunk=32, state0=s0_t)
    err = max(close(yt, yj, "y"), close(St, Sj, "final state"))
    yn, Sn = naive_wkv(**ti, state0=s0_t)
    close(yt, yn, "y vs recurrence", **ORACLE)
    close(St, Sn, "state vs recurrence", **ORACLE)
    print(f"S={s} {'state0' if state else 'zero state'}: max |diff| vs JAX {err:.2e}")


@pytest.mark.parametrize("s", [64, 100])
def test_chunked_wkv_gradient_matches_jax(s):
    inp, s0 = wkv_inputs(s, seed=s + 1, state=True)
    rng = np.random.default_rng(s + 2)
    cy = rng.standard_normal(inp["r"].shape).astype(np.float32)
    cs = rng.standard_normal(s0.shape).astype(np.float32)

    def jloss(i, s0):
        y, S = jr._chunked_wkv(**i, chunk=32, state0=s0)
        return jnp.sum(y * cy) + jnp.sum(S * cs)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(inp, s0)
    ti = {k: t(v).requires_grad_() for k, v in inp.items()}
    s0_t = t(s0).requires_grad_()
    y, S = tr._chunked_wkv(**ti, chunk=32, state0=s0_t)
    ((y * t(cy)).sum() + (S * t(cs)).sum()).backward()
    errs = []
    for k in inp:
        g = ti[k].grad.numpy()
        assert np.isfinite(g).all(), k
        scale = max(1.0, float(np.abs(gj[0][k]).max()))
        errs.append(close(g, gj[0][k], f"d/d{k}", rtol=1e-4, atol=1e-5 * scale))
    errs.append(close(s0_t.grad, gj[1], "d/dstate0"))
    print(f"S={s}: max |grad diff| {max(errs):.2e}")


def test_token_shift_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    last = rng.standard_normal((2, 16)).astype(np.float32)
    np.testing.assert_array_equal(tr._token_shift(t(x), t(last)).numpy(),
                                  np.asarray(jr._token_shift(x, last)))


def configs():
    name = "rwkv6-3b"
    return jax_smoke(JAX_ARCHS[name]), smoke_variant(ARCHS[name])


def block_params(cfg, seed: int = 0, decay_base: float = -6.0):
    """The block's leaves at the reference's scales, drawn with numpy; the
    constant ones perturbed so that each reaches the output."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    n = lambda *shape: rng.standard_normal(shape)
    s = 1.0 / np.sqrt(d)
    p = {"mix_base": 0.5 + 0.1 * n(4, d), "mix_lora_a": n(d, 32) * s,
         "mix_lora_b": n(32, 4 * d) * 0.1 / np.sqrt(32),
         "wr": n(d, d) * s, "wk": n(d, d) * s, "wv": n(d, d) * s, "wg": n(d, d) * s,
         "wo": n(d, d) * s, "decay_base": decay_base + 0.5 * n(d),
         "decay_lora_a": n(d, tr.LORA_RANK) * s,
         "decay_lora_b": n(tr.LORA_RANK, d) * 0.1 / np.sqrt(tr.LORA_RANK),
         "bonus_u": 0.3 * n(d), "ln_x": 0.1 * n(d), "ck": n(d, f) * s,
         "cv": n(f, d) / np.sqrt(f), "cr": n(d, d) * s,
         "cmix_r": 0.5 + 0.1 * n(d), "cmix_k": 0.5 + 0.1 * n(d)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_init_rwkv6_has_the_reference_leaves():
    jcfg, tcfg = configs()
    pj = jr.init_rwkv6(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    pt = tr.init_rwkv6(tcfg, torch.bfloat16, generator=torch.Generator().manual_seed(0),
                       device="cpu", lead=(2,))
    assert sorted(pt) == sorted(pj)
    for k, v in pj.items():
        assert tuple(pt[k].shape) == (2,) + v.shape, k
        assert str(pt[k].dtype).split(".")[-1] == str(v.dtype), k
        if k in ("mix_base", "decay_base", "bonus_u", "ln_x", "cmix_r", "cmix_k"):
            np.testing.assert_array_equal(pt[k][1].float().numpy(),
                                          np.asarray(v).astype(np.float32), err_msg=k)


@pytest.mark.parametrize("decay", ["default", "clamped"])
def test_rwkv6_block_prefill_and_decode_match_jax(decay):
    """Time-mix then channel-mix over a prefill of 70 tokens (past one
    chunk of 64) into an empty cache, then three decode steps: outputs and
    the cache's state, last_t and last_c (the normed inputs of the last
    token) against JAX's; the blocks write them into the buffers of the
    cache they were given.  "clamped": decay_base 2.0, so most log-decays
    hit the clamp at -80/64 in both the chunked and the recurrent path."""
    jcfg, tcfg = configs()
    p = block_params(tcfg, decay_base=2.0 if decay == "clamped" else -6.0)
    xs = np.random.default_rng(3).standard_normal((2, 73, tcfg.d_model)).astype(np.float32)

    def jblock(p, x, c):
        h, c = jr.rwkv6_time_mix(p, jcfg, x, c)
        h2, c = jr.rwkv6_channel_mix(p, jcfg, x + h, c)
        return h, h2, c

    jstep = jax.jit(jblock)
    jc = jr.init_rwkv_cache(2, jcfg, jnp.float32)
    tc = tr.init_rwkv_cache(2, tcfg, torch.float32, device="cpu")
    buffers = [a.data_ptr() for a in tc]
    pt = {k: t(v) for k, v in p.items()}
    errs = []
    for lo, hi in ((0, 70), (70, 71), (71, 72), (72, 73)):
        hj, h2j, jc = jstep(p, xs[:, lo:hi], jc)
        x = t(xs[:, lo:hi])
        ht, c = tr.rwkv6_time_mix(pt, tcfg, x, tc)
        h2t, c = tr.rwkv6_channel_mix(pt, tcfg, x + ht, c)
        assert c is tc and [a.data_ptr() for a in tc] == buffers
        errs += [close(ht, hj, f"time-mix {lo}:{hi}"), close(h2t, h2j, "channel-mix"),
                 close(tc.state, jc.state, "state")]
        # last_t is the given input, last_c the channel-mix's (x + time-mix)
        np.testing.assert_array_equal(tc.last_t.numpy(), np.asarray(jc.last_t))
        errs.append(close(tc.last_c, jc.last_c, "last_c"))
    full, _ = tr.rwkv6_time_mix(pt, tcfg, t(xs))
    close(ht, full[:, -1:], "decode vs chunked", **ORACLE)
    if decay == "clamped":
        xk = t(xs)                          # the clamp binds on most channels
        dec = pt["decay_base"] + torch.tanh(xk @ pt["decay_lora_a"]) @ pt["decay_lora_b"]
        assert (-torch.exp(dec) < -80.0 / tr.RWKV_CHUNK).float().mean() > 0.5
    print(f"{decay}: max |diff| vs JAX {max(errs):.2e}")
