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
#: a GQA variant of danube3 (the smoke variant has n_kv_heads == n_heads)
GQA = dict(n_layers=2, scan_repeats=2, n_heads=4, n_kv_heads=2, head_dim=40)
RTOL, ATOL = 1e-4, 1e-5
BATCH, PROMPT, STEPS = 2, 150, 3


def configs(name: str):
    """The same reduced configuration in both packages."""
    if name == "h2o-danube-3-4b-gqa":
        base = "h2o-danube-3-4b"
        kw = dict(GQA, name=name)
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


@pytest.mark.parametrize("name", DENSE + ["h2o-danube-3-4b-gqa"])
def test_prefill_and_decode_match_jax(name):
    jcfg, tcfg, jparams, tparams = setup(name)
    toks = prompts(jcfg.vocab_size)
    j_prefill = jax.jit(jserve.make_prefill_step(jcfg, backend="chunked"))
    j_decode = jax.jit(jserve.make_decode_step(jcfg, backend="chunked"))
    t_prefill, t_decode = make_prefill_step(tcfg), make_decode_step(tcfg)

    jl, jc = j_prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = t_prefill(tparams, {"tokens": torch.from_numpy(toks)})
    close(tl, jl, f"{name} prefill logits")
    close_caches(tc, jc, f"{name} prefill cache")
    assert tc["length"] == PROMPT
    for step in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        jl, jc = j_decode(jparams, jc, jnp.asarray(tok))
        tl, tc = t_decode(tparams, tc, torch.from_numpy(tok))
        close(tl, jl, f"{name} decode step {step} logits")
        close_caches(tc, jc, f"{name} decode step {step} cache")
    assert tc["length"] == PROMPT + STEPS


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
