"""The kernel wrappers at sizes past the C ``int`` range, on meta tensors.

gemma3-27b's tied table with two agents is one leaf of 2.82e9 values, so
the packed uplink's kernels (``quant_pipeline``, ``unpack_bits``) take a
64-bit n, as ``pack_bits`` and ``quantize_ef`` do.  Meta tensors carry
shapes and allocate nothing; ``_build.launch`` is replaced by a recorder,
so each wrapper runs its card route up to the launch and the test reads
what it would hand the C entry point, each integer converted by the
argument type the table binds it as (a ``c_int`` would wrap 2**31 + 4097
to a negative).  ``sign_pipeline`` and ``erasure_mask`` keep ``int`` sizes
and refuse such a leaf.
"""
import pytest
import torch

from repro_torch.core.compression import quant_constants, wire_index_bits
from repro_torch.kernels import _build, ops
from repro_torch.kernels.pack_bits import LANES, R, n_tiles
from repro_torch.device import cap_test_worker_threads

cap_test_worker_threads()

HUGE_N = 2**31 + 4097
QUANT = dict(levels=255, vmin=-1.0, vmax=1.0)


def _meta(n: int, dtype) -> torch.Tensor:
    return torch.empty(n, dtype=dtype, device="meta")


@pytest.fixture
def recorded(monkeypatch):
    """The launches the wrappers make: [(name, args as the C side gets
    them)], each integer argument passed through its registered ctypes
    type."""
    seen = []

    def record(name, *args):
        types = _build.KERNELS[name][2]
        assert len(args) == len(types), name
        seen.append((name, tuple(t(a).value if isinstance(a, int) else a
                                 for t, a in zip(types, args))))

    monkeypatch.setattr(_build, "launch", record)
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_pipeline_reaches_the_launch_with_64_bit_n(recorded, dtype):
    msg, cache = _meta(HUGE_N, dtype), _meta(HUGE_N, dtype)
    words, new_cache = ops.quant_pipeline(msg, cache, **QUANT)
    bits, tiles = wire_index_bits(QUANT["levels"]), n_tiles(HUGE_N)
    assert tiles == 65537
    assert words.dtype == torch.uint32 and words.numel() == tiles * bits * R * LANES
    assert new_cache.shape == msg.shape and new_cache.dtype == dtype
    [(name, args)] = recorded
    delta, recip, _ = quant_constants(**QUANT)
    assert name == "quant_pipeline"
    assert args[4:8] == (HUGE_N, bits, tiles, QUANT["levels"])
    assert args[-1] == int(dtype == torch.bfloat16)
    assert args[2].numel() == words.numel() and args[3].numel() == HUGE_N
    assert args[10] == pytest.approx(delta) and args[11] == pytest.approx(recip)


@pytest.mark.parametrize("bits", [1, 8, 13, 32])
def test_unpack_bits_reaches_the_launch_with_64_bit_n(recorded, bits):
    tiles = n_tiles(HUGE_N)
    words = _meta(tiles * bits * R * LANES, torch.uint32)
    vals = ops.unpack_bits(words, bits, HUGE_N)
    assert vals.dtype == torch.uint32 and vals.numel() == HUGE_N
    [(name, args)] = recorded
    assert name == "unpack_bits" and args[2:] == (HUGE_N, bits, tiles)
    assert args[0].numel() == tiles * bits * R * LANES and args[1].numel() == HUGE_N


def test_a_32_bit_binding_would_cut_n():
    """The control: the same n through a ``c_int`` is not n."""
    import ctypes
    assert ctypes.c_int(HUGE_N).value != HUGE_N
    assert ctypes.c_longlong(HUGE_N).value == HUGE_N


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sign_pipeline_still_refuses_past_the_int_range(recorded, dtype):
    with pytest.raises(ValueError, match="int sizes"):
        ops.sign_pipeline(_meta(HUGE_N, dtype), _meta(HUGE_N, dtype))
    assert recorded == []


def test_erasure_mask_still_refuses_past_the_int_range(recorded):
    with pytest.raises(ValueError, match="int sizes"):
        ops.erasure_mask(_meta(HUGE_N, torch.uint32), p=0.1, seed=3)
    assert recorded == []


def test_the_largest_int_sizes_still_launch(recorded):
    """sign_pipeline and erasure_mask take 2**31 - 1 values, the last
    their ``int`` holds, and pass it uncut."""
    n = 2**31 - 1
    ops.sign_pipeline(_meta(n, torch.float32), _meta(n, torch.float32))
    ops.erasure_mask(_meta(n, torch.uint32), p=0.1, seed=3)
    assert [(name, args[6] if name == "sign_pipeline" else args[3])
            for name, args in recorded] == [("sign_pipeline", n), ("erasure_mask", n)]
