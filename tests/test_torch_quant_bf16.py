"""quant_pipeline on bf16 msg and cache (a bf16 model's fused uplink)
against the JAX package's Pallas kernel run in interpret mode on the same
bf16 inputs: words word for word and the bf16 new cache bit for bit.

Both compute in float32 (msg and cache widened exactly) and write the new
cache in msg's dtype, rounded to nearest even once.  The inputs hold
values at and next to half-level boundaries (in bf16), out-of-range
values and signed zeros.
"""
import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from repro.kernels.compress_pipeline import quant_pipeline as jax_quant_pipeline
from repro_torch.kernels import compress_pipeline as tcp
from repro_torch.kernels import ops, ref

CONFIGS = [(255, -1.0, 1.0), (1023, -0.5, 0.5), (10, -4.0, 4.0)]


def _bf16_inputs(n, levels, vmin, vmax, seed):
    rng = np.random.default_rng(seed)
    delta = (vmax - vmin) / levels
    half = vmin + (np.arange(min(levels, 300)) + 0.5) * delta
    msg = rng.uniform(1.25 * vmin, 1.25 * vmax, n).astype(np.float32)
    k = min(n, half.size)
    msg[:k] = half[:k]
    msg[k:k + 6] = [vmin, vmax, -0.0, 0.0, 3 * vmin, 3 * vmax]
    cache = rng.uniform(-delta, delta, n).astype(np.float32)
    cache[:k + 6] = 0.0
    to_bf16 = lambda a: a.astype(ml_dtypes.bfloat16)
    return to_bf16(msg), to_bf16(cache)


def _torch_bf16(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("n", [70_001, 2 * 32768])
@pytest.mark.parametrize("levels,vmin,vmax", CONFIGS)
def test_bf16_quant_pipeline_matches_jax_interpret(n, levels, vmin, vmax):
    msg, cache = _bf16_inputs(n, levels, vmin, vmax, n + levels)
    words_j, newc_j = jax_quant_pipeline(jnp.asarray(msg), jnp.asarray(cache),
                                         levels=levels, vmin=vmin, vmax=vmax,
                                         interpret=True)
    assert str(newc_j.dtype) == "bfloat16"
    words_t, newc_t = ops.quant_pipeline(_torch_bf16(msg), _torch_bf16(cache),
                                         levels=levels, vmin=vmin, vmax=vmax)
    assert newc_t.dtype == torch.bfloat16 and newc_t.shape == (n,)
    np.testing.assert_array_equal(words_t.view(torch.int32).numpy().view(np.uint32),
                                  np.asarray(words_j))
    np.testing.assert_array_equal(newc_t.view(torch.int16).numpy(),
                                  np.asarray(newc_j).view(np.int16))


def test_bf16_quant_pipeline_checks():
    """msg and cache of one float dtype the kernel takes, on the card."""
    with pytest.raises(TypeError):
        tcp.quant_pipeline(torch.zeros(4, dtype=torch.bfloat16, device="meta"),
                           torch.zeros(4, dtype=torch.float32, device="meta"))
    with pytest.raises(TypeError):
        tcp.quant_pipeline(torch.zeros(4, dtype=torch.float16, device="meta"),
                           torch.zeros(4, dtype=torch.float16, device="meta"))


@pytest.mark.cuda
def test_cuda_bf16_quant_pipeline_matches_plain():
    """The CUDA kernel on bf16 against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    for levels, vmin, vmax in CONFIGS:
        msg, cache = (_torch_bf16(a).cuda() for a in _bf16_inputs(70_001, levels, vmin,
                                                                  vmax, 0))
        words, newc = tcp.quant_pipeline(msg, cache, levels=levels, vmin=vmin, vmax=vmax)
        words_p, newc_p = ref.quant_pipeline_ref(msg, cache, levels=levels, vmin=vmin,
                                                 vmax=vmax)
        assert torch.equal(words.view(torch.int32), words_p.view(torch.int32))
        assert torch.equal(newc.view(torch.int16), newc_p.view(torch.int16))
