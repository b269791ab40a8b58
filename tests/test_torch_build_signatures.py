"""The ctypes bindings of the port's CUDA kernels against their sources.

``repro_torch.kernels._build.KERNELS`` registers, for each kernel, the C
entry point of a source under ``csrc/`` and its argument types; the
library then gets those types plus the stream.  ctypes checks nothing
against the C side: an argument too few, or an int where the C function
takes a 64-bit integer, binds silently and passes garbage.  So each
entry's ``extern "C"`` signature is parsed from its source and its
parameters' count and kinds (pointer, 64-bit integer, int, float) held to
the registered types.
"""
import ctypes
import re

import pytest

from repro_torch.kernels import _build

# C parameter type -> the ctypes type it must be bound as
KINDS = {
    "void*": ctypes.c_void_p,
    "long long": ctypes.c_longlong,
    "int": ctypes.c_int,
    "unsigned": ctypes.c_uint,
    "float": ctypes.c_float,
}


def c_signature(source: str, symbol: str) -> list:
    """The ctypes types of ``symbol``'s parameters, parsed from the
    ``extern "C"`` definition in ``csrc/<source>``."""
    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C"\s+int\s+' + re.escape(symbol) + r"\s*\(([^)]*)\)", text)
    assert m, f"no extern \"C\" int {symbol}(...) in {source}"
    kinds = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()
        ctype = " ".join(w for w in words[:-1] if w != "const").replace(" *", "*")
        assert ctype in KINDS, f"{symbol}: parameter {param.strip()!r} of an unknown kind"
        kinds.append(KINDS[ctype])
    return kinds


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_registered_argtypes_match_the_c_signature(name):
    source, symbol, argtypes = _build.KERNELS[name]
    assert source in _build.SOURCES
    # the library appends the stream, a pointer, to the registered types
    assert c_signature(source, symbol) == [*argtypes, ctypes.c_void_p], name


def test_every_source_is_bound():
    """Each source under csrc/ that defines a kernel's entry point is
    built and has an entry in the table."""
    built = {src for src, _, _ in _build.KERNELS.values()}
    assert built == set(_build.SOURCES)
    on_disk = {p.name for p in _build.CSRC.glob("*.cu")}
    assert on_disk == set(_build.SOURCES)


def test_a_mismatch_is_seen():
    """The parser reads what is written: the float32 backward's entry takes
    13 pointers, 9 ints and 2 floats before the stream, and a table with
    one int fewer would not match it."""
    kinds = c_signature("flash_attention_bwd.cu", "repro_flash_attention_bwd")
    assert kinds == [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    assert kinds != [*(ctypes.c_void_p,) * 13, *(ctypes.c_int,) * 8,
                     ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
