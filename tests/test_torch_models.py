"""The port's model layers and attention against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both packages.  Tolerance:
rtol 1e-5 / atol 1e-6 for elementwise layers, where only the order of a
float32 sum (a norm's mean) or a library's transcendental differs;
rtol 1e-4 / atol 1e-5 for attention and MLPs, whose products and softmaxes
sum in different orders.  The JAX side runs under ``jax.jit``, whose
arithmetic the port follows (ROADMAP, contract).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.models import attention as jatt
from repro.models import layers as jl
from repro_torch.configs import ARCHS, get, smoke_variant
from repro_torch.convert import kv_cache_to_numpy, model_params_from_jax
from repro_torch.core.pytree import tree_leaves
from repro_torch.kernels import ops
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf

EW = dict(rtol=1e-5, atol=1e-6)
MM = dict(rtol=1e-4, atol=1e-5)


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


# -- configs ------------------------------------------------------------------

def test_catalog_is_the_reference_catalog():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, cfg in ARCHS.items():
        ref = JAX_ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
        assert dataclasses.asdict(smoke_variant(cfg)) == dataclasses.asdict(jax_smoke(ref))
        assert (cfg.q_dim, cfg.kv_dim, cfg.param_count()) == (
            ref.q_dim, ref.kv_dim, ref.param_count())
    danube = get("h2o-danube-3-4b")
    assert (danube.head_dim, danube.n_heads, danube.n_kv_heads,
            danube.sliding_window) == (120, 32, 8, 4096)
    assert abs(danube.param_count() - 3.96e9) < 0.01e9
    with pytest.raises(KeyError):
        get("no-such-arch")


# -- layers -------------------------------------------------------------------

def test_rms_norm_offsets_the_weight_from_one():
    x, w = rand((3, 5, 64), 0), rand((64,), 1, 0.1)
    ours = tl.rms_norm(t(x), t(w), 1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(
        jax.jit(jl.rms_norm)(x, w)), **EW)
    # zero weight is the identity scale, as the JAX package initialises it
    np.testing.assert_allclose(tl.rms_norm(t(x), torch.zeros(64)).numpy(),
                               x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-5),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn(name):
    x = rand((4096,), 2, 3.0)
    np.testing.assert_allclose(tl.act_fn(name)(t(x)).numpy(),
                               np.asarray(jax.jit(jl.act_fn(name))(x)), **EW)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("gelu", True)])
def test_mlp(act, gated):
    params = {"up": rand((64, 96), 3, 0.1), "down": rand((96, 64), 4, 0.1),
              "gate": rand((64, 96), 5, 0.1)}
    if not gated:
        del params["gate"]
    x = rand((2, 7, 64), 6)
    ours = tl.mlp({k: t(v) for k, v in params.items()}, t(x), act, gated)
    theirs = jax.jit(lambda p, x: jl.mlp(p, x, act, gated))(params, x)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **MM)


def test_embed_and_sinusoidal_positions():
    table = rand((50, 32), 7)
    toks = np.random.default_rng(8).integers(0, 50, (3, 9), dtype=np.int32)
    np.testing.assert_array_equal(tl.embed({"table": t(table)}, t(toks)).numpy(),
                                  table[toks])
    pos = np.arange(300, dtype=np.int32)
    np.testing.assert_allclose(
        tl.sinusoidal_positions(t(pos), 64).numpy(),
        np.asarray(jax.jit(lambda p: jl.sinusoidal_positions(p, 64))(pos)),
        rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("rotary_pct,theta,dtype", [
    (1.0, 1e4, np.float32), (0.25, 1e4, np.float32), (1.0, 1e6, np.float32),
    (1.0, 1e4, "bfloat16")])
def test_rope(rotary_pct, theta, dtype):
    b, s, h, d = 2, 40, 3, 40
    pos = np.broadcast_to(np.arange(100, 100 + s, dtype=np.int32), (b, s))
    rot = int(d * rotary_pct) // 2 * 2
    cos_t, sin_t = tl.rope_angles(t(pos.copy()), rot, theta)
    cos_j, sin_j = jax.jit(lambda p: jl.rope_angles(p, rot, theta))(pos)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-5, atol=2e-5)
    x = rand((b, s, h, d), 9)
    xt = t(x) if dtype == np.float32 else t(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.float32 if dtype == np.float32 else jnp.bfloat16)
    # the same angles on both sides: the layer is what is compared
    ours = tl.apply_rope(xt, t(np.asarray(cos_j)), t(np.asarray(sin_j)), rotary_pct)
    theirs = jax.jit(lambda x, c, s_: jl.apply_rope(x, c, s_, rotary_pct))(
        xj, cos_j, sin_j)
    assert ours.dtype == xt.dtype
    tol = EW if dtype == np.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs.astype(jnp.float32)), **tol)
    if rotary_pct < 1:                       # the rest passes through
        np.testing.assert_array_equal(ours[..., rot:].numpy(), x[..., rot:])


def test_mrope_angles():
    pos3 = np.stack([np.random.default_rng(i).integers(0, 500, (2, 30), dtype=np.int32)
                     for i in range(3)])
    cos_t, sin_t = tl.mrope_angles(t(pos3), 64, 1e6)
    cos_j, sin_j = jax.jit(lambda p: jl.mrope_angles(p, 64, 1e6))(pos3)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-5, atol=2e-5)


# -- attention ----------------------------------------------------------------

# (Sq, Sk, H, Hkv, D, window, softcap, offset): offset shifts both position
# ranges by the same amount
ATTN_CASES = [
    (128, 128, 4, 4, 64, None, None, 0),
    (150, 150, 4, 2, 40, 64, None, 0),
    (150, 150, 6, 2, 64, None, 30.0, 0),
    (200, 200, 4, 1, 64, 50, 30.0, 1000),
]


def attn_inputs(sq, sk, h, hkv, d, seed):
    return (rand((2, sq, h, d), seed), rand((2, sk, hkv, d), seed + 1),
            rand((2, sk, hkv, d), seed + 2))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_backends_match_jax(case):
    sq, sk, h, hkv, d, window, softcap, offset = case
    q, k, v = attn_inputs(sq, sk, h, hkv, d, seed=sq + h)
    qp = np.arange(offset, offset + sq, dtype=np.int32)
    kp = np.arange(offset, offset + sk, dtype=np.int32)
    kw = dict(window=window, softcap=softcap)
    j_xla = jax.jit(lambda *a: jatt.attention_xla(*a, **kw))(q, k, v, qp, kp)
    j_chunked = jax.jit(lambda *a: jatt.attention_chunked(
        *a, chunk_q=64, chunk_k=64, **kw))(q, k, v, qp, kp)
    t_xla = tatt.attention_xla(t(q), t(k), t(v), t(qp), t(kp), **kw)
    t_chunked = ops.attention(t(q), t(k), t(v), causal=True, q_pos=t(qp),
                              k_pos=t(kp), **kw)
    for ours, name in ((t_xla, "xla"), (t_chunked, "chunked")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(j_xla), **MM,
                                   err_msg=name)
        np.testing.assert_allclose(ours.numpy(), np.asarray(j_chunked), **MM,
                                   err_msg=name)


def test_chunked_backend_takes_queries_after_their_keys():
    """A chunk of queries at the end of a longer key range (Sq < Sk, as a
    prefill continuing a cache): the plain flash version against the
    reference's oracle attention_xla, with GQA, a window and a softcap."""
    q, k, v = attn_inputs(70, 300, 8, 2, 64, seed=11)
    qp = np.arange(230, 300, dtype=np.int32)
    kp = np.arange(300, dtype=np.int32)
    kw = dict(window=100, softcap=20.0)
    theirs = jax.jit(lambda *a: jatt.attention_xla(*a, **kw))(q, k, v, qp, kp)
    ours = ops.attention(t(q), t(k), t(v), q_pos=t(qp), k_pos=t(kp), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **MM)


def _block_setup(quant: bool, seed: int = 0):
    # chunks of 16: the reference's chunked backend needs a chunk of keys no
    # longer than the prompt (tests/test_torch_serve.py)
    kw = dict(n_kv_heads=2, kv_cache_int8=quant, chunk_size=16)
    cfg_j = dataclasses.replace(jax_smoke(JAX_ARCHS["h2o-danube-3-4b"]), **kw)
    cfg_t = dataclasses.replace(smoke_variant(ARCHS["h2o-danube-3-4b"]), **kw)
    pj = jatt.init_attention(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    pt = model_params_from_jax(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("quant", [False, True], ids=["kv", "kv_int8"])
@pytest.mark.parametrize("prompt", [20, 40], ids=["fits", "past_ring"])
def test_attention_block_with_cache_matches_jax(quant, prompt):
    """Prefill into a 32-slot cache (a ring when the prompt is longer),
    then two decode steps, with float32 or int8 (QuantKVCache) buffers."""
    cfg_j, cfg_t, pj, pt = _block_setup(quant)
    s_max, b = 32, 2
    xs = rand((b, prompt + 2, cfg_t.d_model), 12)
    jc = jatt.init_kv_cache(b, s_max, 2, cfg_j.head_dim, jnp.float32, quantized=quant)
    tc = tatt.init_kv_cache(b, s_max, 2, cfg_t.head_dim, torch.float32,
                            quantized=quant, device="cpu")
    assert isinstance(tc, tatt.QuantKVCache if quant else tatt.KVCache)
    window = cfg_t.sliding_window
    for lo, hi in ((0, prompt), (prompt, prompt + 1), (prompt + 1, prompt + 2)):
        start = tc.length
        pos = np.arange(start, start + hi - lo, dtype=np.int32)
        cos, sin = jl.rope_angles(jnp.asarray(pos)[None].repeat(b, 0), 64, 1e4)
        jo, jc = jax.jit(lambda p, x, c, cs, s: jatt.attention_block(
            p, cfg_j, x, rope_cs=cs, window=window, cache=c, backend="chunked"))(
            pj, xs[:, lo:hi], jc, (cos, sin), None)
        to, tc = tatt.attention_block(
            pt, cfg_t, t(xs[:, lo:hi]), rope_cs=(t(np.asarray(cos)), t(np.asarray(sin))),
            window=window, cache=tc, backend="chunked")
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **MM)
        assert tc.length == int(jc.length) == hi
        for name in tc._fields[:-1]:
            ours, theirs = getattr(tc, name).numpy(), np.asarray(getattr(jc, name))
            if ours.dtype == np.int8:      # int8 codes: equal
                np.testing.assert_array_equal(ours, theirs, err_msg=name)
            else:
                np.testing.assert_allclose(ours, theirs, **MM, err_msg=name)


# -- transformer ----------------------------------------------------------------

def test_init_params_has_the_reference_tree():
    from repro.models import transformer as jtf
    for name in ("gemma3-27b", "granite-20b", "qwen2-vl-7b", "zamba2-2.7b",
                 "mixtral-8x7b", "grok-1-314b", "rwkv6-3b"):
        cfg_j, cfg_t = jax_smoke(JAX_ARCHS[name]), smoke_variant(ARCHS[name])
        pj = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), cfg_j))
        pt = ttf.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                             device="cpu")
        shapes_j = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
        shapes_t = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), pt)
        assert shapes_t == shapes_j, name


def test_init_params_bf16_norms_stay_float32():
    cfg = dataclasses.replace(smoke_variant(ARCHS["h2o-danube-3-4b"]), dtype="bfloat16")
    p = ttf.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert p["scan"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert p["scan"][0]["ln1"].dtype == torch.float32
    assert p["final_norm"].dtype == torch.float32 and not p["final_norm"].any()
    std = p["scan"][0]["mlp"]["down"].float().std().item()
    assert abs(std - 1 / np.sqrt(cfg.d_ff)) < 0.1 / np.sqrt(cfg.d_ff)


def test_scan_unroll_waits_for_the_launch_slice():
    """cfg.scan_unroll (the dry-run's costing path, no longer waiting):
    attention takes attention_chunked_unrolled, and the forward's logits
    equal the default chunked backend's at float32 (both attend exactly)."""
    cfg = dataclasses.replace(smoke_variant(ARCHS["stablelm-1.6b"]), dtype="float32")
    unrolled = dataclasses.replace(cfg, scan_unroll=True)
    p = ttf.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(4))
    want = ttf.forward(p, cfg, {"tokens": toks}).logits
    got = ttf.forward(p, unrolled, {"tokens": toks}).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_lm_loss_at_remat_group_2_matches_jax_and_group_1(monkeypatch):
    """cfg.remat_group 2 on stablelm-1.6b's smoke variant at two scan units:
    the port checkpoints both units as one group, as the JAX package's
    two-level remat does.  lm_loss and every gradient equal jax.jit's at
    remat_group 2 (rtol 1e-5 on the loss, atol 1e-6 on the gradients,
    float32, 64 tokens: one chunk) and the port's at remat_group 1 bit for
    bit (a group only changes what the backward recomputes), through one
    checkpoint where remat_group 1 takes one per unit.  The port runs
    on one thread: the CPU's embedding backward sums a token's rows in
    another order from call to call when it has several."""
    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.models import transformer as jtf
    from repro_torch.core.pytree import tree_unflatten
    kw = dict(n_layers=2, scan_repeats=2, remat_group=2)
    cfg_j = dataclasses.replace(jax_smoke(JAX_ARCHS["stablelm-1.6b"]), **kw)
    cfg_t = dataclasses.replace(smoke_variant(ARCHS["stablelm-1.6b"]), **kw)
    pj = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    batch_j = jax_make_batch(cfg_j, jax.random.PRNGKey(3), 2, 64)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, cfg_j, batch_j)))(pj)
    pt = model_params_from_jax(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    batch_t = {k: t(v).long() for k, v in batch_j.items()}
    segments, plain_checkpoint = [], ttf.checkpoint

    def counted(fn, x, r0, **kw):
        segments.append(r0)
        return plain_checkpoint(fn, x, r0, **kw)

    monkeypatch.setattr(ttf, "checkpoint", counted)
    runs, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for group in (2, 1):
            leaves = [x.detach().clone().requires_grad_() for x in tree_leaves(pt)]
            cfg = dataclasses.replace(cfg_t, remat_group=group)
            loss = ttf.lm_loss(tree_unflatten(pt, leaves), cfg, batch_t)
            runs[group] = (loss.detach(), torch.autograd.grad(loss, leaves))
    finally:
        torch.set_num_threads(threads)
    assert segments == [0, 0, 1]       # the first unit of each checkpointed segment
    loss_t, grads_t = runs[2]
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=EW["rtol"])
    leaves_j = jax.tree_util.tree_leaves(grads_j)
    assert len(leaves_j) == len(grads_t)
    for gj, gt in zip(leaves_j, grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **EW)
    assert torch.equal(runs[1][0], loss_t)
    assert all(torch.equal(a, b) for a, b in zip(runs[1][1], grads_t))


# (Sq, H, Hkv, D, window, softcap, chunk_q, chunk_k): Sq off the chunks pads
# both the queries (position -1) and the keys (position 2**30)
UNROLLED_CASES = [
    (150, 4, 2, 32, None, None, 64, 64),
    (200, 4, 1, 32, 50, 30.0, 64, 32),
    (128, 4, 4, 16, None, None, 128, 128),
    (130, 6, 2, 16, 40, None, 32, 64),
]


@pytest.mark.parametrize("case", UNROLLED_CASES, ids=str)
def test_attention_chunked_unrolled_matches_jax(case):
    """The dry-run's loop-free chunk pairs against jax.jit of the JAX
    package's, float32, at rtol 1e-5: causal and windowed, softcapped, GQA,
    padded chunks."""
    s, h, hkv, d, window, softcap, cq, ck = case
    q, k, v = attn_inputs(s, s, h, hkv, d, seed=s + h + d)
    pos = np.arange(s, dtype=np.int32)
    kw = dict(window=window, softcap=softcap, chunk_q=cq, chunk_k=ck)
    want = jax.jit(lambda *a: jatt.attention_chunked_unrolled(*a, **kw))(q, k, v, pos, pos)
    got = tatt.attention_chunked_unrolled(t(q), t(k), t(v), t(pos), t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_catalog_arch_prefills_decodes_and_trains(name, dtype):
    """init_params, init_cache, forward (a prefill of 80 tokens into a cache
    of 96, then a decode step) and lm_loss's gradient run for each of the
    10 architectures' smoke variants, in float32 and bf16: logits and
    gradients finite, each gradient in its leaf's dtype, the MoE configs'
    aux loss positive and the others' zero."""
    cfg = dataclasses.replace(smoke_variant(ARCHS[name]), dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = ttf.init_params(cfg, generator=gen, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 81), generator=gen)
    cache = ttf.init_cache(cfg, 2, 96, device="cpu")
    out = ttf.forward(params, cfg, {"tokens": toks[:, :80]}, cache=cache)
    out = ttf.forward(params, cfg, {"tokens": toks[:, 80:]}, cache=out.cache)
    assert out.cache["length"] == 81 and torch.isfinite(out.logits).all()
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    batch = {"tokens": toks[:, :64], "labels": toks[:, 1:65]}
    aux = float(ttf.forward(params, cfg, batch).aux_loss.detach())
    loss = ttf.lm_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss)
    assert all(g.dtype == x.dtype and torch.isfinite(g).all() for g, x in zip(grads, leaves))
    assert aux > 0.0 if cfg.n_experts else aux == 0.0


def test_forward_with_extra_embeds_and_mrope_positions():
    """VLM/audio stubs prepend embeddings; M-RoPE takes its (3, B, S)
    positions from the batch."""
    from repro.models import transformer as jtf
    cfg_j, cfg_t = jax_smoke(JAX_ARCHS["qwen2-vl-7b"]), smoke_variant(ARCHS["qwen2-vl-7b"])
    pj = jtf.init_params(jax.random.PRNGKey(3), cfg_j)
    pt = model_params_from_jax(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 70), dtype=np.int32)
    extra = rand((2, 10, cfg_t.d_model), 4, 0.02)
    pos3 = np.stack([np.broadcast_to(np.arange(80, dtype=np.int32) // (i + 1), (2, 80))
                     for i in range(3)])
    batch = {"tokens": toks, "extra_embeds": extra, "positions": pos3}
    theirs = jax.jit(lambda p, b: jtf.forward(p, cfg_j, b).logits)(pj, batch)
    ours = ttf.forward(pt, cfg_t, {k: t(v) for k, v in batch.items()}).logits
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **MM)


def test_kv_cache_to_numpy_shapes_lengths_like_jax():
    from repro.models import transformer as jtf
    cfg_j, cfg_t = jax_smoke(JAX_ARCHS["gemma3-27b"]), smoke_variant(ARCHS["gemma3-27b"])
    jc = jtf.init_cache(cfg_j, 2, 16)
    tc = kv_cache_to_numpy(ttf.init_cache(cfg_t, 2, 16, device="cpu"))
    assert jax.tree_util.tree_map(np.shape, tc) == jax.tree_util.tree_map(np.shape, jc)
