"""The port's training path against the JAX package: ``lm_loss`` and its
gradient, ``DeployFedLT.round_step`` on every branch, and the launcher.

Inputs are made once on the JAX side (parameters from its PRNG key, token
batches from its Markov source) and carried into the port as numpy, so
both packages compute from the same numbers.  Each round starts both
packages from the JAX state, and the port's result is held against
``jax.jit``-compiled JAX, on the CPU, in float32:

* compression off: every leaf within rtol 1e-5 / atol 1e-6;
* compression on: x and z within the same tolerance; a quantized leaf
  (the uplink EF cache, ŷ and the downlink cache) may part from JAX's
  only where a level index flipped by one, and only at a coordinate whose
  quantized input lies within 1e-4·Δ of a half-level boundary (a rounding
  tie between the two packages' float32 sums), or where an uplink flip
  moved the mean; the flips are counted.

The config's MLP leaves hold 65,536 values with the agent axis, so with
``pack_wire`` they take the packed branches (fused or unfused) while the
other eight leaves gather plain ints.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke_variant as jax_smoke
from repro.core.deploy import DeployFedLT as JaxDeploy
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxConfig
from repro_torch import convert
from repro_torch.core.deploy import DeployFedLT
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.pack_bits import _TILE_VALS
from repro_torch.launch import train
from repro_torch.models import transformer as ttf
from repro_torch.models.config import ModelConfig

CFG_KW = dict(name="deploy-port-test", arch_type="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=128, max_seq=128,
              chunk_size=32, tie_embeddings=True, dtype="float32", rotary_pct=0.5)
CFG_J, CFG_T = JaxConfig(**CFG_KW), ModelConfig(**CFG_KW)
RTOL, ATOL = 1e-5, 1e-6
TIE = 1e-4              # a flip is allowed within TIE·Δ of a half-level boundary

np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _jax_batch(seed: int, n_agents: int = 2, batch: int = 2, seq: int = 32):
    per = [jax_make_batch(CFG_J, jax.random.fold_in(jax.random.PRNGKey(seed), i),
                          batch, seq) for i in range(n_agents)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)


def _port_batch(batch_j):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch_j.items()}


def test_lm_loss_and_gradient_match_jax():
    """lm_loss and every parameter's gradient against jax.value_and_grad of
    repro.models.transformer.lm_loss (jit), labels −1 ignored; rtol 1e-5
    on the loss, atol 1e-6 on the gradients (float32, depth 2)."""
    pj = jtf.init_params(jax.random.PRNGKey(0), CFG_J)
    batch_j = {k: v[0] for k, v in _jax_batch(3).items()}
    batch_j["labels"] = batch_j["labels"].at[0, 5].set(-1).at[1, :4].set(-1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, CFG_J, batch_j)))(pj)
    pt = tree_map(lambda t: t.requires_grad_(),
                  convert.model_params_from_jax(np_tree(pj), device="cpu"))
    loss_t = ttf.lm_loss(pt, CFG_T, _port_batch(batch_j))
    grads_t = torch.autograd.grad(loss_t, tree_leaves(pt))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=RTOL)
    leaves_j = jax.tree_util.tree_leaves(grads_j)
    assert len(leaves_j) == len(grads_t)
    for gj, gt in zip(leaves_j, grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)


def test_lm_loss_without_remat_is_the_same():
    """remat only changes what is kept for the backward, not the numbers."""
    pt = ttf.init_params(CFG_T, generator=torch.Generator().manual_seed(0), device="cpu")
    pt = tree_map(lambda t: t.requires_grad_(), pt)
    batch = _port_batch({k: v[0] for k, v in _jax_batch(4).items()})
    grads = []
    for remat in (True, False):
        out = ttf.forward(pt, CFG_T, batch, remat=remat)
        grads.append(torch.autograd.grad(out.logits.square().mean(), tree_leaves(pt)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _near_boundary(m, levels, vmin, vmax):
    delta = (vmax - vmin) / levels
    u = (np.clip(np.asarray(m, np.float64), vmin, vmax) - vmin) / delta
    return np.abs(u - np.floor(u) - 0.5) <= TIE


def _close(a, b):
    return np.abs(a - b) <= ATOL + RTOL * np.abs(b)


def _check_round(alg_kw, s0_j, s1_j, s1_t, m_j, m_t, survivors) -> int:
    """One round's port state against JAX's from the same start; returns
    the number of uplink and downlink level flips (each a demonstrated
    rounding tie, or a downlink move caused by an uplink flip)."""
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    port = convert.deploy_state_to_numpy(s1_t)
    for field in ("x", "z"):
        for a, b in zip(leaves(getattr(port, field)), leaves(getattr(s1_j, field))):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=RTOL)
    assert int(port.k) == int(s1_j.k)
    if not alg_kw.get("compress", True):
        for field in ("c_up", "y_hat", "c_down"):
            for a, b in zip(leaves(getattr(port, field)), leaves(getattr(s1_j, field))):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        return 0
    levels, vmin, vmax = alg_kw["levels"], alg_kw["vmin"], alg_kw["vmax"]
    delta = (vmax - vmin) / levels
    assert m_t["wire_nbytes_per_agent"] == float(m_j["wire_nbytes_per_agent"])
    if survivors is not None:
        assert float(m_t["quorum_frac"]) == float(m_j["quorum_frac"])
    flips = 0
    for i, (c_t, c_j, z_j, c0) in enumerate(zip(
            leaves(port.c_up), leaves(s1_j.c_up), leaves(s1_j.z), leaves(s0_j.c_up))):
        bad = ~_close(c_t, c_j)
        # one level apart, at a tie of JAX's corrected message z + c_up
        assert np.all(np.abs(np.abs(c_t - c_j)[bad] - delta) <= 1e-5), i
        assert np.all(_near_boundary((z_j + c0)[bad], levels, vmin, vmax)), i
        flips += int(bad.sum())
        up_flip = bad.any(axis=0)
        yh_t, yh_j = leaves(port.y_hat)[i], leaves(s1_j.y_hat)[i]
        cd_t, cd_j = leaves(port.c_down)[i], leaves(s1_j.c_down)[i]
        bad_y = ~_close(yh_t, yh_j)
        assert np.all(np.abs(np.abs(yh_t - yh_j)[bad_y] - delta) <= 1e-5), i
        tie_y = _near_boundary((cd_j + yh_j)[bad_y], levels, vmin, vmax)
        assert np.all(tie_y | up_flip[bad_y]), i
        flips += int(bad_y.sum())
        bad_cd = ~_close(cd_t, cd_j)
        assert np.all((bad_y | up_flip)[bad_cd]), i
        assert np.all(np.abs(cd_t - cd_j)[bad_cd] <= delta + 1e-5), i
    return flips


def _counting(monkeypatch):
    calls = {"quant_pipeline": 0, "pack_bits": 0, "unpack_bits": 0}
    for name in calls:
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, wrapped)
    return calls


QUANT = dict(compress=True, levels=1023, vmin=-0.5, vmax=0.5)
ROUND_CASES = [
    ("off", dict(compress=False), None),
    ("quant", QUANT, None),
    ("packed-fused", dict(QUANT, pack_wire=True), None),
    ("packed-unfused", dict(QUANT, pack_wire=True, fuse_pipeline=False), None),
    ("survivors", dict(compress=True, levels=255, vmin=-4.0, vmax=4.0), [True, False]),
]


@pytest.mark.parametrize("name,alg_kw,survivors", ROUND_CASES,
                         ids=[c[0] for c in ROUND_CASES])
def test_round_step_matches_jax(name, alg_kw, survivors, monkeypatch):
    """Two rounds of DeployFedLT.round_step, each from the JAX state carried
    into the port, against jax.jit(round_step); with pack_wire, the three
    tile-sized leaves take one quant_pipeline and one unpack_bits each
    (fused) or one pack_bits and one unpack_bits each (unfused), and the
    other eight gather plain ints."""
    kw = dict(n_epochs=2, gamma=0.05, rho=10.0, **alg_kw)
    alg_j, alg_t = JaxDeploy(cfg=CFG_J, **kw), DeployFedLT(cfg=CFG_T, **kw)
    surv_j = None if survivors is None else jnp.asarray(survivors)
    step = jax.jit(lambda s, b: alg_j.round_step(s, b, survivors=surv_j))
    state = alg_j.init(jax.random.PRNGKey(0), 2)
    sizes = [x.size for x in jax.tree_util.tree_leaves(state.x)]
    assert sum(n >= _TILE_VALS for n in sizes) == 3 and len(sizes) == 11
    calls = _counting(monkeypatch)
    flips = 0
    for k in range(2):
        batch = _jax_batch(10 + k)
        s1_j, m_j = step(state, batch)
        before = dict(calls)
        s1_t, m_t = alg_t.round_step(convert.deploy_state_from_jax(np_tree(state), "cpu"),
                                     _port_batch(batch), survivors=survivors)
        made = {n: calls[n] - before[n] for n in calls}
        if not alg_kw.get("pack_wire"):
            assert made == {"quant_pipeline": 0, "pack_bits": 0, "unpack_bits": 0}
        elif alg_kw.get("fuse_pipeline", True):
            assert made == {"quant_pipeline": 3, "pack_bits": 0, "unpack_bits": 3}
        else:
            assert made == {"quant_pipeline": 0, "pack_bits": 3, "unpack_bits": 3}
        flips += _check_round(alg_kw, np_tree(state), np_tree(s1_j), s1_t, m_j, m_t,
                              survivors)
        state = s1_j
    n_coords = 2 * sum(sizes)
    assert flips <= 1e-3 * n_coords, (name, flips)
    print(f"{name}: {flips} level flips, each a half-level tie, over 2 rounds")


def test_round_step_agent_replicate_spec_raises():
    alg = DeployFedLT(cfg=CFG_T)
    state = alg.init(2, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1"):
        alg.round_step(state, {}, agent_replicate_spec=object())


def test_round_step_leaves_its_input_state_alone():
    """The round is functional: the state it was given is unchanged."""
    alg = DeployFedLT(cfg=CFG_T, **QUANT, pack_wire=True)
    state = alg.init(2, generator=torch.Generator().manual_seed(1), device="cpu")
    before = [t.clone() for t in tree_leaves(tuple(state)[:5])]
    new, _ = alg.round_step(state, _port_batch(_jax_batch(20)))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tuple(state)[:5])))
    assert new.k == 1 and state.k == 0


def test_launcher_checkpoint_restores_in_jax(tmp_path):
    """python -m repro_torch.launch.train --smoke on the CPU: two rounds,
    finite losses, and a checkpoint of ŷ that the JAX package restores
    leaf for leaf."""
    run = train.main(["--arch", "stablelm-1.6b", "--smoke", "--rounds", "2",
                      "--checkpoint-dir", str(tmp_path)], device="cpu")
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert run.checkpoints == [str(tmp_path / "round_000002")]
    assert run.launches == [{}, {}]                   # the CPU launches nothing
    like = jtf.init_params(jax.random.PRNGKey(0), jax_smoke(JAX_ARCHS["stablelm-1.6b"]))
    restored = jstore.restore(run.checkpoints[0], like)
    assert jstore.load_meta(run.checkpoints[0])["step"] == 2
    ours = tree_leaves(run.state.y_hat)
    theirs = jax.tree_util.tree_leaves(restored)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_federated_lm_example_on_the_cpu():
    """The example's smoke preset (levels 1023 over ±0.5) for two short
    rounds on the CPU: finite losses, one per round."""
    from repro_torch.examples import train_federated_lm
    losses = train_federated_lm.main(["--rounds", "2", "--agents", "2", "--batch", "2",
                                      "--seq", "64"], device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))


# -- a bf16 model: where the port's quantizer parts from the JAX package's --

BF16_QUANTS = [dict(levels=1023, vmin=-0.5, vmax=0.5), dict(levels=255, vmin=-1.0, vmax=1.0)]


def _jax_bf16_quantizer(m, levels, vmin, vmax):
    """The JAX package's quantize_encode / quantize_decode on a bf16 array
    as XLA compiles them for the CPU, written in torch bf16 ops: every op
    rounds to bf16, and so do the constants Δ and vmin (a Python float
    takes the array's dtype).  (ints, lattice points), both bf16."""
    d = torch.tensor((vmax - vmin) / levels, dtype=torch.bfloat16)
    lo = torch.tensor(vmin, dtype=torch.bfloat16)
    idx = ((m.clamp(vmin, vmax) - lo) / d + 0.5).floor().clamp(0, levels)
    return idx, idx * d + lo


def _bf16(a):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("quant", BF16_QUANTS, ids=lambda q: f"L{q['levels']}")
def test_bf16_round_split_from_jax(quant):
    """A bf16 model's round (compression on, the launcher's unfused uplink)
    against jax.jit(round_step), from the same state.

    The port quantizes the uplink's z + c_up and the downlink's y in
    float32 on every route, as both packages' fused kernel does.  The JAX
    package's unfused uplink and its downlink compute the quantizer in bf16
    ops, with Δ and vmin rounded to bf16 (``_jax_bf16_quantizer``, held
    here bit for bit to JAX's own arithmetic), so its ints and lattice
    points part from the quantizer's.  Held:

    * where: on JAX's z and c_up, the port's ints and caches equal JAX's
      float32 arithmetic (and, on the tile-sized leaves, its fused kernel
      in interpret mode) bit for bit, and JAX's unfused arithmetic equals
      the bf16 model; the int split is counted;
    * size: x and z within 2**-6·|x| + 1e-3 (bf16 local training; the
      quantizer is not on their path); the port's ŷ on the quantizer's
      lattice and its in-range c_down within Δ/2 (one bf16 rounding); ŷ
      within (1 + 2·e)·Δ + 2·max|Δz| + 0.05·Δ of JAX's, where e is the bf16
      quantizer's largest round-trip error over every bf16 value in
      [vmin, vmax], in levels (each package lands ŷ within its own
      round-trip error of y, twice: uplink and downlink).
    """
    from repro.core import compression as jc
    from repro.kernels.compress_pipeline import quant_pipeline as jax_quant_pipeline
    from repro_torch.core.deploy import _quantize_ef
    from repro_torch.kernels.ref import unpack_bits_ref
    levels, vmin, vmax = quant["levels"], quant["vmin"], quant["vmax"]
    delta = (vmax - vmin) / levels
    kw16 = dict(CFG_KW, dtype="bfloat16")
    kw = dict(n_epochs=2, gamma=0.05, rho=10.0, compress=True, **quant)
    alg_j = JaxDeploy(cfg=JaxConfig(**kw16), **kw)
    alg_t = DeployFedLT(cfg=ModelConfig(**kw16), **kw)
    state = alg_j.init(jax.random.PRNGKey(0), 2)
    batch = _jax_batch(10)
    s1_j, m_j = jax.jit(alg_j.round_step)(state, batch)
    s1_t, m_t = alg_t.round_step(convert.deploy_state_from_jax(np_tree(state), "cpu"),
                                 _port_batch(batch))
    leaves = lambda t: [np.asarray(x).astype(np.float32) for x in jax.tree_util.tree_leaves(t)]
    port = convert.deploy_state_to_numpy(s1_t)

    # where: the uplink on JAX's z and c_up, leaf by leaf
    jax_unfused = jax.jit(lambda m: (lambda w: (w, m - jc.quantize_decode(
        w, levels, vmin, vmax, m.dtype)))(jc.quantize_encode(m, levels, vmin, vmax)))
    split = worst = 0
    n_bf16 = 0
    for z, c in zip(jax.tree_util.tree_leaves(s1_j.z), jax.tree_util.tree_leaves(state.c_up)):
        w_t, nc_t = _quantize_ef(_bf16(z) if z.dtype == jnp.bfloat16 else
                                 torch.from_numpy(np.array(z)),
                                 _bf16(c) if c.dtype == jnp.bfloat16 else
                                 torch.from_numpy(np.array(c)), alg_t.quant)
        w32, nc32 = jax_unfused(z.astype(jnp.float32) + c.astype(jnp.float32))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w32))
        np.testing.assert_array_equal(nc_t.float().numpy(),
                                      np.asarray(nc32.astype(z.dtype)).astype(np.float32))
        if z.dtype != jnp.bfloat16:
            continue
        n_bf16 += 1
        w16, nc16 = jax_unfused(z + c)
        idx_m, lat_m = _jax_bf16_quantizer(_bf16(z) + _bf16(c), levels, vmin, vmax)
        np.testing.assert_array_equal(idx_m.to(torch.int64).numpy(),
                                      np.asarray(w16).astype(np.int64))
        np.testing.assert_array_equal(((_bf16(z) + _bf16(c)) - lat_m).float().numpy(),
                                      np.asarray(nc16).astype(np.float32))
        d = np.abs(np.asarray(w16).astype(np.int64) - w_t.to(torch.int64).numpy())
        split += int((d > 0).sum())
        worst = max(worst, int(d.max()))
        if z.size >= _TILE_VALS:
            words_j, newc_j = jax_quant_pipeline(z, c, levels=levels, vmin=vmin, vmax=vmax,
                                                 interpret=True)
            ints = unpack_bits_ref(torch.from_numpy(np.array(words_j).view(np.int32)),
                                   alg_t.wire_word_bits, z.size)
            np.testing.assert_array_equal(ints.numpy().reshape(z.shape),
                                          w_t.to(torch.int64).numpy())
            np.testing.assert_array_equal(nc_t.float().numpy(),
                                          np.asarray(newc_j).astype(np.float32))
    assert n_bf16 >= 8 and split > 0

    # size: the round's state
    dz = 0.0
    for field in ("x", "z"):
        for a, b in zip(leaves(getattr(port, field)), leaves(getattr(s1_j, field))):
            np.testing.assert_allclose(a, b, rtol=2**-6, atol=1e-3)
            if field == "z":
                dz = max(dz, float(np.abs(a - b).max()))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=1e-4)
    assert m_t["wire_nbytes_per_agent"] == float(m_j["wire_nbytes_per_agent"])
    grid = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    grid = grid[torch.isfinite(grid) & (grid >= vmin) & (grid <= vmax)]
    e = float((_jax_bf16_quantizer(grid, levels, vmin, vmax)[1].double() - grid.double())
              .abs().max()) / delta
    limit = (1 + 2 * e) * delta + 2 * dz + 0.05 * delta
    gap = 0.0
    for yh_t, yh_j, cd_t in zip(leaves(port.y_hat), leaves(s1_j.y_hat), leaves(port.c_down)):
        u = (yh_t.astype(np.float64) - vmin) / delta
        assert np.all(np.abs(u - np.round(u)) <= 2**-8 * np.abs(u) + 1e-3)
        y_t = cd_t.astype(np.float64) + yh_t
        inside = (y_t >= vmin) & (y_t <= vmax)
        assert np.all(np.abs(cd_t[inside]) <= (0.5 + 2**-8) * delta)
        gap = max(gap, float(np.abs(yh_t - yh_j).max()))
    assert gap <= limit, (gap / delta, limit / delta)
    print(f"L={levels}: uplink ints part from JAX's bf16 arithmetic at {split} "
          f"coordinates, by up to {worst} levels; ŷ within {gap / delta:.3f}·Δ of "
          f"JAX's (limit {limit / delta:.3f}·Δ, e = {e:.3f})")
