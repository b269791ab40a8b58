"""The port's serving steps against the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_params`` and are converted
(``repro_torch.convert``); prompts are drawn with numpy.  Both sides run
``make_prefill_step`` and then three ``make_decode_step``s, fed the same
greedy tokens (JAX's argmax), in float32: the JAX steps under ``jax.jit``
with the chunked backend, the port's with its chunked backend, which on
the CPU is the flash kernel's plain version.

Tolerance: logits and caches at rtol 1e-4 / atol 1e-5.  The two packages
sum their matrix products and softmaxes in different orders, and JAX's
chunked backend runs an online softmax where the port's plain version
takes one softmax over the row.

Prompts are 150 tokens: past the smoke variants' 128-token window, so the
sliding-window layers fill their ring from a longer prefill, and at least
JAX's chunk of 64 keys, below which its chunked backend visits no key
(see ``test_short_prompt_jax_chunked_visits_no_key``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.convert import (data_to_numpy, kv_cache_from_jax,
                                 kv_cache_to_numpy, model_params_from_jax)
from repro_torch.core.pytree import tree_leaves
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.models import transformer as ttf

DENSE = ["stablelm-1.6b", "h2o-danube-3-4b", "gemma3-27b", "granite-20b",
         "musicgen-large", "qwen2-vl-7b"]
#: MoE (dense dispatch in the smoke variants, and mixtral's with the
#: catalog's capacity dispatch), Mamba2 with a shared attention block, RWKV6
LATER = ["grok-1-314b", "mixtral-8x7b", "mixtral-8x7b-capacity", "zamba2-2.7b",
         "rwkv6-3b"]
#: a GQA variant of danube3 (the smoke variant has n_kv_heads == n_heads)
GQA = dict(n_layers=2, scan_repeats=2, n_heads=4, n_kv_heads=2, head_dim=40)
#: danube3 with the int8 KV cache (QuantKVCache rings: int8 codes and a
#: float32 scale per batch row, slot and head; decode attends their
#: dequantized values)
INT8 = dict(kv_cache_int8=True)
RTOL, ATOL = 1e-4, 1e-5
BATCH, PROMPT, STEPS = 2, 150, 3


def configs(name: str):
    """The same reduced configuration in both packages."""
    variants = {"h2o-danube-3-4b-gqa": ("h2o-danube-3-4b", GQA),
                "h2o-danube-3-4b-int8": ("h2o-danube-3-4b", INT8),
                "mixtral-8x7b-capacity": ("mixtral-8x7b", dict(moe_dispatch="capacity"))}
    if name in variants:
        base, kw = variants[name]
        kw = dict(kw, name=name)
        return (dataclasses.replace(jax_smoke(JAX_ARCHS[base]), **kw),
                dataclasses.replace(smoke_variant(ARCHS[base]), **kw))
    return jax_smoke(JAX_ARCHS[name]), smoke_variant(ARCHS[name])


def setup(name: str, seed: int = 0):
    jcfg, tcfg = configs(name)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = model_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, tcfg, jparams, tparams


def prompts(vocab: int, length: int = PROMPT, seed: int = 1):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, length),
                                                dtype=np.int32)


def close(ours, theirs, what: str) -> None:
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def close_caches(ours, theirs, what: str) -> None:
    ours = jax.tree_util.tree_leaves(kv_cache_to_numpy(ours))
    theirs = jax.tree_util.tree_leaves(theirs)
    assert len(ours) == len(theirs), what
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == np.shape(b), f"{what}: leaf {i}"
        close(a, b, f"{what}: leaf {i}")


def serve_both(name: str, batch: dict, length: int):
    """A prefill of ``batch`` (numpy leaves) and STEPS decode steps fed
    JAX's greedy tokens, in both packages: logits and caches equal at
    rtol 1e-4 / atol 1e-5 after each step.  Returns the port's last cache."""
    jcfg, tcfg, jparams, tparams = setup(name)
    j_prefill = jax.jit(jserve.make_prefill_step(jcfg, backend="chunked"))
    j_decode = jax.jit(jserve.make_decode_step(jcfg, backend="chunked"))
    t_prefill, t_decode = make_prefill_step(tcfg), make_decode_step(tcfg)

    jl, jc = j_prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = t_prefill(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(tl, jl, f"{name} prefill logits")
    close_caches(tc, jc, f"{name} prefill cache")
    assert tc["length"] == length
    for step in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        jl, jc = j_decode(jparams, jc, jnp.asarray(tok))
        tl, tc = t_decode(tparams, tc, torch.from_numpy(tok))
        close(tl, jl, f"{name} decode step {step} logits")
        close_caches(tc, jc, f"{name} decode step {step} cache")
    assert tc["length"] == length + STEPS
    return tc


@pytest.mark.parametrize("name", DENSE + ["h2o-danube-3-4b-gqa"] + LATER)
def test_prefill_and_decode_match_jax(name):
    jcfg, _ = configs(name)
    serve_both(name, {"tokens": prompts(jcfg.vocab_size)}, PROMPT)


def test_int8_kv_cache_prefill_and_decode_match_jax():
    """danube3's smoke variant with ``kv_cache_int8``: prefill of 2 x 150
    tokens into its 128-slot int8 ring, then three decode steps, each from
    the JAX package's cache of the step before (converted, as the deploy
    tests start each round from JAX's state) and fed JAX's greedy token,
    against jax.jit of the JAX package's steps.  Logits, scales and
    positions within rtol 1e-4 / atol 1e-5 after every step.  The int8
    codes are equal, save one level where the value quantized lies within
    1e-3 of a half-level tie (the two packages' float32 K and V sums part by
    an ulp there), that value read from the port's float32 cache run in
    lockstep (one layer, so its K/V are the int8 route's); the flips are
    counted and stay under 1e-3 of the codes."""
    jcfg, tcfg, jparams, tparams = setup("h2o-danube-3-4b-int8")
    assert tcfg.kv_cache_int8 and tcfg.n_layers == 1 and PROMPT > tcfg.sliding_window
    plain = dataclasses.replace(tcfg, kv_cache_int8=False)
    j_prefill = jax.jit(jserve.make_prefill_step(jcfg, backend="chunked"))
    j_decode = jax.jit(jserve.make_decode_step(jcfg, backend="chunked"))
    t_decode, f_decode = make_decode_step(tcfg), make_decode_step(plain)
    tok = prompts(jcfg.vocab_size)
    jl, jc = j_prefill(jparams, {"tokens": jnp.asarray(tok)})
    tl, tc = make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(tok)})
    _, fc = make_prefill_step(plain)(tparams, {"tokens": torch.from_numpy(tok)})
    flips = codes = 0
    for step in range(STEPS + 1):
        what = "prefill" if step == 0 else f"decode step {step - 1}"
        close(tl, jl, f"int8 cache, {what} logits")
        for ours, theirs, f32 in zip(tc["scan"], jc["scan"], fc["scan"]):
            np.testing.assert_array_equal(ours.pos.numpy(), np.asarray(theirs.pos))
            for name in ("k", "v"):
                scale = getattr(ours, f"{name}_scale")
                close(scale, getattr(theirs, f"{name}_scale"), f"{what}: {name} scales")
                diff = getattr(ours, name).numpy().astype(int) - np.asarray(
                    getattr(theirs, name)).astype(int)
                u = (getattr(f32, name) / scale.clamp(min=1e-8)[..., None]).double().numpy()
                tie = np.abs(u - np.floor(u) - 0.5) <= 1e-3
                assert np.all(np.abs(diff) <= 1) and np.all(tie[diff != 0]), (what, name)
                flips += int(np.count_nonzero(diff))
                codes += diff.size
        if step == STEPS:
            break
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        start = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
        jl, jc = j_decode(jparams, jc, jnp.asarray(nxt))
        tl, tc = t_decode(tparams, start, torch.from_numpy(nxt))
        _, fc = f_decode(tparams, fc, torch.from_numpy(nxt))
    assert tc["length"] == PROMPT + STEPS
    assert flips <= 1e-3 * codes, flips


def test_vlm_prefill_with_a_vision_prefix_matches_jax():
    """qwen2-vl's prefill of the JAX package's VLM batch (``make_batch``,
    vision_frac 0.25): 37 ``extra_embeds`` rows prepended to 113 text
    tokens, at the M-RoPE grid positions (3, B, S) the batch carries; then
    3 decode steps at the positions that follow the cache's length."""
    from repro.data.synthetic import make_batch as jax_make_batch
    jcfg, _ = configs("qwen2-vl-7b")
    vlm = jax_make_batch(jcfg, jax.random.PRNGKey(2), BATCH, PROMPT)
    batch = {k: np.array(vlm[k]) for k in ("tokens", "extra_embeds", "positions")}
    s_vis = PROMPT // 4
    assert batch["extra_embeds"].shape == (BATCH, s_vis, jcfg.d_model)
    assert batch["positions"].shape == (3, BATCH, PROMPT)
    assert (batch["positions"][0, :, :s_vis] == 0).all()     # the image's grid
    serve_both("qwen2-vl-7b", batch, PROMPT)


def test_local_rings_after_a_prompt_the_window_divides_match_jax():
    """gemma3's smoke variant (window 128: five local layers at RoPE θ 1e4,
    then a global one at θ 1e6) after a prompt of twice the window: each
    local ring holds the last 128 positions in order, so decode writes the
    slot of the position leaving the window; prefill and 3 decode steps
    equal JAX's, logits and caches."""
    jcfg, tcfg = configs("gemma3-27b")
    assert tcfg.sliding_window == 128 and tcfg.rope_theta_local != tcfg.rope_theta
    assert tcfg.scan_unit == ("attn_local",) * 5 + ("attn",)
    prompt = 2 * tcfg.sliding_window
    tc = serve_both("gemma3-27b", {"tokens": prompts(jcfg.vocab_size, prompt)}, prompt)
    last = prompt + STEPS - 1
    want = [p if p > last - 128 else p + 128 for p in range(prompt - 128, prompt)]
    for slot in tc["scan"][:5]:
        assert slot.pos.shape == (1, 128)
        assert slot.pos[0].tolist() == want
    assert tc["scan"][5].pos.shape == (1, prompt)


@pytest.mark.parametrize("name", ["gemma3-27b", "granite-20b", "qwen2-vl-7b",
                                  "musicgen-large"])
def test_params_round_trip_through_convert(name):
    """The smoke parameters both ways, bit for bit: the JAX package's tree
    into the port and back, and the port's own draw out and back in, each
    leaf under its JAX name, shape and dtype (granite's learned
    ``pos_table``, gemma3's float32 q/k norms)."""
    jcfg, tcfg, jparams, tparams = setup(name)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    back = jax.tree_util.tree_flatten_with_path(data_to_numpy(tparams))[0]
    assert [p for p, _ in back] == [p for p, _ in jflat]
    for (path, a), (_, b) in zip(back, jflat):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    names = {jax.tree_util.keystr(p) for p, _ in jflat}
    assert ("['pos_table']" in names) == (name == "granite-20b")
    assert any("q_norm" in n for n in names) == (name == "gemma3-27b")

    own = ttf.init_params(tcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    again = model_params_from_jax(data_to_numpy(own), device="cpu")
    ours, theirs = tree_leaves(own), tree_leaves(again)
    assert [(t.shape, t.dtype) for t in ours] == [(tuple(np.shape(b)), t.dtype)
                                                  for t, (_, b) in zip(ours, jflat)]
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(ours, theirs))


def test_decode_step_updates_its_cache_in_place():
    """A decode step writes into the buffers of the cache it is given and
    returns them (no copy of the cache per step); what it writes equals
    JAX's new cache, checked in test_serving_steps_match_jax."""
    _, tcfg, _, tparams = setup("stablelm-1.6b")
    toks = torch.from_numpy(prompts(tcfg.vocab_size, 64))
    logits, cache = make_prefill_step(tcfg)(tparams, {"tokens": toks})
    before = kv_cache_to_numpy(cache)
    _, after = make_decode_step(tcfg)(tparams, cache, logits.argmax(-1, keepdim=True))
    given, returned = tree_leaves(cache), tree_leaves(after)
    assert len(given) == len(returned)
    for a, b in zip(given, returned):
        if isinstance(a, torch.Tensor):
            assert a.data_ptr() == b.data_ptr()
    # the prompt filled every slot, so the ring write lands on slot 0 only
    kc = after["scan"][0].k
    changed = (kc.numpy() != before["scan"][0].k).any(axis=(0, 1, 3, 4))
    assert changed.tolist() == [True] + [False] * (kc.shape[2] - 1)
    assert after["length"] == 64 + 1


@pytest.mark.parametrize("name", ["zamba2-2.7b", "rwkv6-3b"])
def test_decode_step_updates_ssm_and_rwkv_caches_in_place(name):
    """The Mamba2 and RWKV6 blocks write the new state, conv carry and last
    inputs into the buffers of the cache they are given (views of each
    stacked slot), so the decode step returns the given buffers and every
    recurrent buffer moved; what they hold equals JAX's (checked in
    test_prefill_and_decode_match_jax)."""
    from repro_torch.models.mamba2 import SSMCache
    from repro_torch.models.rwkv6 import RWKVCache
    _, tcfg, _, tparams = setup(name)
    toks = torch.from_numpy(prompts(tcfg.vocab_size, 64))
    logits, cache = make_prefill_step(tcfg)(tparams, {"tokens": toks})
    before = kv_cache_to_numpy(cache)
    _, after = make_decode_step(tcfg)(tparams, cache, logits.argmax(-1, keepdim=True))
    given, returned = tree_leaves(cache), tree_leaves(after)
    assert len(given) == len(returned)
    for a, b in zip(given, returned):
        if isinstance(a, torch.Tensor):
            assert a.data_ptr() == b.data_ptr()
    kinds = (SSMCache, RWKVCache)
    slots = [i for i, c in enumerate(after["scan"]) if isinstance(c, kinds)]
    assert slots
    for i in slots:
        for field, old in zip(after["scan"][i]._fields, before["scan"][i]):
            new = getattr(after["scan"][i], field).numpy()
            assert new.shape == old.shape and (new != old).any(), (i, field)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "rwkv6-3b"])
def test_ssm_and_rwkv_caches_round_trip_through_convert(name):
    """The JAX package's SSMCache / RWKVCache (no length field) after a
    prefill convert to the port's and back, leaf for leaf."""
    jcfg, tcfg, jparams, _ = setup(name)
    toks = prompts(jcfg.vocab_size, 64)
    _, jc = jax.jit(jserve.make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(toks)})
    tc = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert tc["length"] == 64
    kinds = {type(c).__name__ for c in tc["scan"]}
    assert kinds & {"SSMCache", "RWKVCache"}
    back = kv_cache_to_numpy(tc)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_kv_cache_round_trips_through_convert():
    jcfg, _, _, _ = setup("gemma3-27b")
    jc = jtf.init_cache(jcfg, BATCH, 32)
    tc = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert tc["length"] == 0 and tc["scan"][0].length == 0
    close_caches(tc, jc, "empty cache")


def test_bf16_params_round_trip_through_convert():
    """bf16 leaves come from numpy through float32 and stay bf16; norms stay
    float32, as the JAX package makes them."""
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS["granite-20b"]), dtype="bfloat16")
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = model_params_from_jax(jparams, device="cpu")
    assert tparams["scan"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert tparams["final_norm"].dtype == torch.float32
    back = data_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


def _full_next_logits(jcfg, tcfg, jparams, tparams, toks):
    tl = ttf.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)}).logits[:, -1]
    jl = jax.jit(lambda p, t: jtf.forward(p, jcfg, {"tokens": t}).logits[:, -1])(
        jparams, jnp.asarray(toks))
    close(tl, jl, "full forward")
    return tl.numpy()


def test_decode_after_prefill_evicts_the_oldest_prompt_token():
    """The reference's serving steps size every cache to the prompt
    (repro/launch/serve.py:21), so the first decode step ring-writes slot 0
    over the oldest prompt token.  The port does the same: its decode
    equals JAX's and both differ from a full forward over prompt + token.
    With room in the cache (init_cache(s_max > prompt)) both equal it."""
    jcfg, tcfg, jparams, tparams = setup("stablelm-1.6b")
    toks = prompts(jcfg.vocab_size, 65)
    prompt, nxt = toks[:, :64], toks[:, 64:]
    full = _full_next_logits(jcfg, tcfg, jparams, tparams, toks)

    _, jc = jax.jit(jserve.make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(prompt)})
    jl, _ = jax.jit(jserve.make_decode_step(jcfg))(jparams, jc, jnp.asarray(nxt))
    _, tc = make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(prompt)})
    tl, _ = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(nxt))
    close(tl, jl, "decode after make_prefill_step")
    assert np.abs(tl.numpy() - full).max() > 1e-2           # slot 0 evicted

    jc = jtf.forward(jparams, jcfg, {"tokens": jnp.asarray(prompt)},
                     cache=jtf.init_cache(jcfg, BATCH, 128)).cache
    jl, _ = jax.jit(jserve.make_decode_step(jcfg))(jparams, jc, jnp.asarray(nxt))
    tc = ttf.forward(tparams, tcfg, {"tokens": torch.from_numpy(prompt)},
                     cache=ttf.init_cache(tcfg, BATCH, 128, device="cpu")).cache
    tl, _ = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(tl.numpy(), full, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jl), full, rtol=0, atol=1e-5)


def test_short_prompt_jax_chunked_visits_no_key():
    """Below one chunk of keys (cfg.chunk_size = 64 in the smoke variants)
    the reference's attention_chunked gets chunk_q < chunk_k and its band
    ends at hi = chunk_q // chunk_k = 0: every key is masked and each row
    averages V.  The port's chunked backend (the flash kernel's contract)
    equals the reference's xla backend there."""
    jcfg, tcfg, jparams, tparams = setup("stablelm-1.6b")
    toks = prompts(jcfg.vocab_size, 40)
    j_chunked, _ = jax.jit(jserve.make_prefill_step(jcfg, backend="chunked"))(
        jparams, {"tokens": jnp.asarray(toks)})
    j_xla, _ = jax.jit(jserve.make_prefill_step(jcfg, backend="xla"))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(toks)})
    close(tl, j_xla, "port chunked vs JAX xla")
    assert np.abs(np.asarray(j_chunked) - np.asarray(j_xla)).max() > 1e-2


@pytest.mark.parametrize("prompt_len,exact", [(150, False), (256, True)])
def test_ring_after_long_prefill_is_exact_when_the_window_divides_the_prompt(
        prompt_len, exact):
    """A prefill longer than a window ring keeps the last W entries in
    order, so slot i holds position S − W + i; decode writes slot
    S % W.  Only when W divides S is that the slot of the position leaving
    the window (the danube3 run on the card: S = 8192, W = 4096).  Else
    decode overwrites a token still in the window, in JAX as in the port."""
    jcfg, tcfg, jparams, tparams = setup("h2o-danube-3-4b")
    assert tcfg.sliding_window == 128
    toks = prompts(jcfg.vocab_size, prompt_len + 1)
    full = _full_next_logits(jcfg, tcfg, jparams, tparams, toks)
    prompt, nxt = toks[:, :-1], toks[:, -1:]
    _, jc = jax.jit(jserve.make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(prompt)})
    jl, _ = jax.jit(jserve.make_decode_step(jcfg))(jparams, jc, jnp.asarray(nxt))
    _, tc = make_prefill_step(tcfg)(tparams, {"tokens": torch.from_numpy(prompt)})
    tl, _ = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(nxt))
    close(tl, jl, "decode after a long prefill")
    if exact:
        np.testing.assert_allclose(tl.numpy(), full, rtol=0, atol=1e-5)
    else:
        assert np.abs(tl.numpy() - full).max() > 1e-2
