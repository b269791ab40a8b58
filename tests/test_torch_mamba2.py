"""The port's Mamba-2 block (``repro_torch.models.mamba2``) against the JAX
package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
JAX side runs under ``jax.jit``.  The chunked SSD is checked at S in {16,
64, 100, 130} (chunk 32: one short chunk, whole chunks, padded ones) with
and without a carried state, and its gradient; the causal conv with and
without a carry; the block (zamba2-2.7b's smoke variant: d 256, 16 heads
of 32, N 32, one group, conv 4, chunk 64) through a prefill and three
decode steps, its cache updated in place.

Tolerance: float32 rtol 1e-4 / atol 1e-5 against JAX (the packages sum in
different orders); against the port's own step-by-step recurrence
(``naive_ssd``) rtol / atol 2e-4, the reference's own oracle tolerance
(``tests/test_ssm_oracles.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import mamba2 as jm
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.models import mamba2 as tm
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE = dict(rtol=2e-4, atol=2e-4)
LENGTHS = [16, 64, 100, 130]


def t(x):
    return torch.from_numpy(np.array(x))


def close(ours, theirs, what: str, **tol) -> float:
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, **(tol or TOL), err_msg=what)
    return float(np.abs(ours - theirs).max())


def naive_ssd(xh, dt, a, Bm, Cm, d_skip, state0=None):
    """The recurrence one token at a time, in the port (float32)."""
    b, s, h, p = xh.shape
    rep = h // Bm.shape[2]
    B, C = Bm.repeat_interleave(rep, dim=2), Cm.repeat_interleave(rep, dim=2)
    S = torch.zeros((b, h, p, Bm.shape[3])) if state0 is None else state0
    ys = []
    for i in range(s):
        a_t = torch.exp(-dt[:, i] * a)
        S = a_t[:, :, None, None] * S + (dt[:, i, :, None] * xh[:, i])[..., None] \
            * B[:, i, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", S, C[:, i]) + d_skip[:, None] * xh[:, i])
    return torch.stack(ys, dim=1), S


def ssd_inputs(s: int, seed: int, state: bool):
    b, h, p, g, n = 2, 4, 8, 2, 16
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    inp = dict(xh=f(b, s, h, p), dt=np.log1p(np.exp(f(b, s, h))).astype(np.float32),
               a=np.exp(0.3 * f(h)).astype(np.float32), Bm=0.3 * f(b, s, g, n),
               Cm=0.3 * f(b, s, g, n), d_skip=1.0 + 0.1 * f(h))
    return inp, (0.5 * f(b, h, p, n) if state else None)


@pytest.mark.parametrize("state", [False, True], ids=["zero_state", "state0"])
@pytest.mark.parametrize("s", LENGTHS)
def test_ssd_chunked_matches_jax_and_the_recurrence(s, state):
    inp, s0 = ssd_inputs(s, seed=s, state=state)
    yj, Sj = jax.jit(lambda i, s0: jm._ssd_chunked(**i, chunk=32, state0=s0))(inp, s0)
    ti = {k: t(v) for k, v in inp.items()}
    s0_t = None if s0 is None else t(s0)
    yt, St = tm._ssd_chunked(**ti, chunk=32, state0=s0_t)
    err = max(close(yt, yj, "y"), close(St, Sj, "final state"))
    yn, Sn = naive_ssd(**ti, state0=s0_t)
    close(yt, yn, "y vs recurrence", **ORACLE)
    close(St, Sn, "state vs recurrence", **ORACLE)
    print(f"S={s} {'state0' if state else 'zero state'}: max |diff| vs JAX {err:.2e}")


@pytest.mark.parametrize("s", [64, 100])
def test_ssd_chunked_gradient_matches_jax(s):
    """The training path: the gradient of ⟨y, cy⟩ + ⟨S, cs⟩ in every input,
    finite (the decay is masked before its exp)."""
    inp, s0 = ssd_inputs(s, seed=s + 1, state=True)
    rng = np.random.default_rng(s + 2)
    cy = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    cs = rng.standard_normal(s0.shape).astype(np.float32)

    def jloss(i, s0):
        y, S = jm._ssd_chunked(**i, chunk=32, state0=s0)
        return jnp.sum(y * cy) + jnp.sum(S * cs)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1)))(inp, s0)
    ti = {k: t(v).requires_grad_() for k, v in inp.items()}
    s0_t = t(s0).requires_grad_()
    y, S = tm._ssd_chunked(**ti, chunk=32, state0=s0_t)
    ((y * t(cy)).sum() + (S * t(cs)).sum()).backward()
    errs = []
    for k in inp:
        g = ti[k].grad.numpy()
        assert np.isfinite(g).all(), k
        scale = max(1.0, float(np.abs(gj[0][k]).max()))
        errs.append(close(g, gj[0][k], f"d/d{k}", rtol=1e-4, atol=1e-5 * scale))
    errs.append(close(s0_t.grad, gj[1], "d/dstate0"))
    print(f"S={s}: max |grad diff| {max(errs):.2e}")


@pytest.mark.parametrize("carry", [False, True], ids=["no_carry", "carry"])
def test_causal_conv_matches_jax(carry):
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = (0.2 * rng.standard_normal((4, 12))).astype(np.float32)
    b = (0.1 * rng.standard_normal(12)).astype(np.float32)
    c = rng.standard_normal((2, 3, 12)).astype(np.float32) if carry else None
    oj, cj = jax.jit(jm._causal_conv)(u, w, b, c)
    ot, ct = tm._causal_conv(t(u), t(w), t(b), None if c is None else t(c))
    close(ot, oj, "conv out")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # one token at a time with the carry equals the whole sequence
    steps, cc = [], None if c is None else t(c)
    for i in range(u.shape[1]):
        o, cc = tm._causal_conv(t(u[:, i:i + 1]), t(w), t(b), cc if cc is not None
                                else torch.zeros((2, 3, 12)))
        steps.append(o)
    close(torch.cat(steps, 1), ot, "step by step", rtol=1e-6, atol=1e-6)


def configs():
    name = "zamba2-2.7b"
    return jax_smoke(JAX_ARCHS[name]), smoke_variant(ARCHS[name])


def block_params(cfg, seed: int = 0):
    """The block's leaves at the reference's scales and dtypes, drawn with
    numpy; the deterministic ones perturbed so that each reaches the output."""
    rng = np.random.default_rng(seed)
    d, d_in, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_heads
    conv_dim = d_in + 2 * cfg.ssm_n_groups * cfg.ssm_state
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    p = {"in_proj": f(d, 2 * d_in + 2 * cfg.ssm_n_groups * cfg.ssm_state + h) / np.sqrt(d),
         "conv_w": 0.2 * f(cfg.ssm_conv, conv_dim), "conv_b": 0.1 * f(conv_dim),
         "a_log": np.log(np.linspace(1.0, 16.0, h)),
         "d_skip": 1.0 + 0.1 * f(h), "dt_bias": 0.1 * f(h),
         "norm_scale": 0.1 * f(d_in), "out_proj": f(d_in, d) / np.sqrt(d_in)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_init_mamba2_has_the_reference_leaves():
    jcfg, tcfg = configs()
    pj = jm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    pt = tm.init_mamba2(tcfg, torch.bfloat16, generator=torch.Generator().manual_seed(0),
                        device="cpu", lead=(2,))
    assert sorted(pt) == sorted(pj)
    for k, v in pj.items():
        assert tuple(pt[k].shape) == (2,) + v.shape, k
        assert str(pt[k].dtype).split(".")[-1] == str(v.dtype), k
        if k in ("a_log", "d_skip", "dt_bias", "norm_scale", "conv_b"):
            np.testing.assert_allclose(pt[k][1].float().numpy(),
                                       np.asarray(v).astype(np.float32), rtol=1e-6)


def test_mamba2_block_prefill_and_decode_match_jax():
    """A prefill of 70 tokens (past one chunk of 64) into an empty cache,
    then three decode steps: each step's output and the cache's state and
    conv carry against JAX's; the block writes them into the buffers of
    the cache it was given and returns that cache."""
    jcfg, tcfg = configs()
    p = block_params(tcfg)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 73, tcfg.d_model)).astype(np.float32)
    jstep = jax.jit(lambda p, x, c: jm.mamba2_block(p, jcfg, x, c))
    jc = jm.init_ssm_cache(2, jcfg, jnp.float32)
    tc = tm.init_ssm_cache(2, tcfg, torch.float32, device="cpu")
    buffers = [a.data_ptr() for a in tc]
    pt = {k: t(v) for k, v in p.items()}
    errs = []
    for lo, hi in ((0, 70), (70, 71), (71, 72), (72, 73)):
        oj, jc = jstep(p, xs[:, lo:hi], jc)
        ot, tc2 = tm.mamba2_block(pt, tcfg, t(xs[:, lo:hi]), tc)
        assert tc2 is tc and [a.data_ptr() for a in tc] == buffers
        errs += [close(ot, oj, f"out {lo}:{hi}"), close(tc.state, jc.state, "state"),
                 close(tc.conv, jc.conv, "conv carry")]
    # and the decode recurrence continues the chunked prefill: the outputs
    # equal one chunked pass over the 73 tokens
    full, _ = tm.mamba2_block(pt, tcfg, t(xs))
    close(ot, full[:, -1:], "decode vs chunked", **ORACLE)
    print(f"max |diff| vs JAX {max(errs):.2e}")


def test_mamba2_block_in_bf16_is_as_close_to_float32_as_jax():
    """bf16 activations and weights with float32 leaves and state, as a bf16
    model holds them.  The two packages round at different places, so each
    is held to the float32 result of the same (bf16-valued) inputs: the
    port's relative L2 error there is at most 1.25 times JAX's own."""
    jcfg, tcfg = configs()
    p = block_params(tcfg, seed=1)
    bf = ("in_proj", "conv_w", "conv_b", "out_proj")
    pj = {k: jnp.asarray(v, jnp.bfloat16) if k in bf else v for k, v in p.items()}
    pt = {k: t(v).to(torch.bfloat16) if k in bf else t(v) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 80, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    oj, _ = jax.jit(lambda p, x: jm.mamba2_block(p, jcfg, x))(
        pj, jnp.asarray(x.float().numpy(), jnp.bfloat16))
    ot, _ = tm.mamba2_block(pt, tcfg, x)
    assert ot.dtype == torch.bfloat16
    ref, _ = tm.mamba2_block({k: v.float() for k, v in pt.items()}, tcfg, x.float())
    rel = lambda a: float(np.linalg.norm(a - ref.numpy()) / np.linalg.norm(ref.numpy()))
    e_t, e_j = rel(ot.float().numpy()), rel(np.asarray(oj).astype(np.float32))
    assert e_t <= 1.25 * e_j, (e_t, e_j)
    print(f"bf16 rel L2 from float32: port {e_t:.2e}, JAX {e_j:.2e}")
