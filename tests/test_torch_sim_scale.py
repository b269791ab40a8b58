"""The port's cohort uplink transport against ``benchmarks/sim_scale.py``.

A 20-satellite Walker over one station with a flat 10% segment-loss
channel (``benchmarks/sim_scale.py``'s lossy scenario below 1000
satellites), 2 sync rounds from seed 0.  Both packages' engines give the
same deliveries and cohorts; the updates are the same numpy draw.  Then
the four chains run on each side: the fused ``quant_pipeline`` per cohort
and the historical ``quantize_ef → pack_bits`` per satellite, each with
and without ``erasure_mask``.  The port runs its plain versions (CPU);
the JAX package runs its Pallas kernels in interpret mode.

Tolerance: none.  Every chain's words are compared word for word, every
output of the chain and not only the last.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.channel import ChannelModel, SelectiveRepeatARQ
from repro_torch.bench import sim_scale as tss
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
N_SATS, ROUNDS, SEED = 20, 2, 0


@pytest.fixture(scope="module")
def setup():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import sim_scale as bss
    clean = bss._scenario(N_SATS)
    lossy = jsim.Scenario(name=f"scale-{N_SATS}-lossy", walker=clean.walker,
                          stations=clean.stations,
                          channel=ChannelModel(loss=tss.P_LOSS,
                                               arq=SelectiveRepeatARQ(max_rounds=4)))
    t_clean, t_lossy = tss.scenarios(N_SATS)
    assert repr(t_lossy) == repr(lossy) and repr(t_clean) == repr(clean)
    res_j = tss.engine_rounds(jsim.Engine(lossy, seed=SEED), ROUNDS)
    res_t = tss.engine_rounds(tss.Engine(t_lossy, seed=SEED), ROUNDS)
    assert [r.to_dict() for r in res_t] == [r.to_dict() for r in res_j]
    vals_np = np.random.default_rng(SEED).normal(
        0.0, 0.3, (N_SATS, tss.DIM)).astype(np.float32)
    vals_t = tss.updates(N_SATS, SEED, "cpu")
    np.testing.assert_array_equal(vals_t.numpy(), vals_np)
    return bss, res_j, res_t, jnp.asarray(vals_np), vals_t


class _Recorder:
    """The port's dispatchers, keeping every word buffer a chain makes."""

    def __init__(self):
        self.words = []

    def quantize_ef(self, *a, **k):
        return ops.quantize_ef(*a, **k)

    def quant_pipeline(self, *a, **k):
        words, newc = ops.quant_pipeline(*a, **k)
        self.words.append(words)
        return words, newc

    def pack_bits(self, *a, **k):
        out = ops.pack_bits(*a, **k)
        self.words.append(out)
        return out

    def erasure_mask(self, *a, **k):
        masked, keep = ops.erasure_mask(*a, **k)
        self.words += [masked, keep]
        return masked, keep


def _jax_chains(bss, vals, results):
    """The benchmark's four chains with every word buffer kept."""
    kw = dict(levels=tss.LEVELS, vmin=tss.VMIN, vmax=tss.VMAX, interpret=True)
    out = {"unfused": [], "fused": [], "lossy_unfused": [], "lossy_fused": []}
    zeros = jnp.zeros((tss.DIM,), jnp.float32)
    for res in results:
        for d in res.deliveries:
            wire, _ = bss.quantize_ef(vals[d.sat], zeros, **kw)
            words = bss.pack_bits(wire, 8, interpret=True)
            out["unfused"].append(words)
            masked, keep = bss.erasure_mask(words, p=tss.P_LOSS, seed=SEED,
                                            interpret=True)
            out["lossy_unfused"] += [words, masked, keep]
        for cohort in res.cohorts():
            stack = vals[np.asarray(cohort.sats)]
            words, _ = bss.quant_pipeline(stack, jnp.zeros_like(stack), **kw)
            out["fused"].append(words)
            masked, keep = bss.erasure_mask(words, p=tss.P_LOSS, seed=SEED,
                                            interpret=True)
            out["lossy_fused"] += [words, masked, keep]
    return out


def test_four_chains_match_word_for_word(setup):
    bss, res_j, res_t, vals_j, vals_t = setup
    theirs = _jax_chains(bss, vals_j, res_j)
    chains = {
        "unfused": lambda k: tss.uplink_unfused(vals_t, res_t, kern=k),
        "fused": lambda k: tss.uplink_fused(vals_t, res_t, kern=k),
        "lossy_unfused": lambda k: tss.lossy_unfused(vals_t, res_t, tss.P_LOSS,
                                                     SEED, kern=k),
        "lossy_fused": lambda k: tss.lossy_fused(vals_t, res_t, tss.P_LOSS,
                                                 SEED, kern=k),
    }
    for name, chain in chains.items():
        rec = _Recorder()
        last = chain(rec)
        assert len(rec.words) == len(theirs[name]) > 0, name
        for ours, jw in zip(rec.words, theirs[name]):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(jw))
        # the chain returns its last words, and the plain namespace agrees
        assert torch.equal(last.view(torch.int32),
                           chain(tss.PLAIN).view(torch.int32))
    # the benchmark's own lossless chains: their last words
    np.testing.assert_array_equal(
        tss.uplink_unfused(vals_t, res_t).numpy(),
        np.asarray(bss._uplink_unfused(vals_j, res_j)))
    np.testing.assert_array_equal(
        tss.uplink_fused(vals_t, res_t).numpy(),
        np.asarray(bss._uplink_fused(vals_j, res_j)))


def test_fused_indices_equal_unfused_wire(setup):
    _, _, res_t, _, vals_t = setup
    checked, bad = tss.decoded_agree(vals_t, res_t)
    assert checked == tss.chain_counts(res_t)["deliveries"] > 0 and bad == 0


def test_round_pipeline_and_lossy_round_on_cpu():
    before = ops.launch_counts()
    out = tss.lossy_round(N_SATS, rounds=ROUNDS, seed=SEED, device="cpu", reps=1)
    assert out["device"] == "cpu" and out["passes"] == 2
    assert out["cohorts"] > 0 and out["deliveries"] >= out["cohorts"]
    assert out["words_fused"].dtype == torch.uint32
    assert torch.equal(out["words_fused"], tss.lossy_fused(
        out["vals"], out["results"], tss.P_LOSS, SEED, kern=tss.PLAIN))
    pipe = tss.round_pipeline(N_SATS, rounds=ROUNDS, seed=SEED, device="cpu", reps=1)
    assert pipe["scenario"] == f"scale-{N_SATS}" and pipe["uplink_ms_fused"] > 0
    assert ops.launch_counts() == before          # the CPU launches nothing
