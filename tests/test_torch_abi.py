"""The C entries of ``paddle_tpu_torch/csrc`` against the ctypes
signatures their Python wrappers load them with, on the CPU.

ctypes does not read a C declaration: a wrapper's ``argtypes`` are
written by hand, and an entry that gains, loses or retypes a parameter
would be passed shifted arguments on the card without an error. So,
for every ``extern "C" int ptt_*`` entry of
each library's ``.cu`` source, the declared parameters are parsed and
mapped to ctypes (any pointer and ``cudaStream_t`` to ``c_void_p``,
``int`` to ``c_int``, ``long long`` to ``c_longlong``, ``float`` to
``c_float``) and must equal the wrapper's signature, in order; and each
library's wrapper declares every entry its source exports, and no
other.
"""
import ctypes
import re
from pathlib import Path

import pytest

from paddle_tpu_torch.ops.kernels import flash_attention, fused
from paddle_tpu_torch.ops.kernels import paged_attention, serving_fused

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"

#: library (the stem of its ``.cu`` source) -> the signatures its wrapper
#: passes to ``_build.load``
LIBS = {
    "decode_attention": fused.DECODE_SIGNATURES,
    "flash_attention": flash_attention.SIGNATURES,
    "flash_chunk": serving_fused.FLASH_CHUNK_SIGNATURES,
    "fused": fused.SIGNATURES,
    "paged_decode": paged_attention.PAGED_DECODE_SIGNATURES,
    "rope": fused.ROPE_SIGNATURES,
}
ENTRIES = [(lib, name) for lib, sigs in LIBS.items() for name in sigs]
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(ptt_\w+)\s*\(([^)]*)\)', re.S)


def _ctype(param: str):
    """The ctypes type of one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl or decl.startswith("cudaStream_t"):
        return ctypes.c_void_p
    words = decl.split()[:-1]              # the type, without the name
    types = {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong,
             ("float",): ctypes.c_float}
    if tuple(words) not in types:
        raise ValueError(f"no ctypes mapping for the parameter {decl!r}")
    return types[tuple(words)]


def _exports(lib: str) -> dict:
    """{entry name: [ctypes of its parameters]} of ``csrc/<lib>.cu``."""
    src = (CSRC / f"{lib}.cu").read_text()
    return {name: [_ctype(p) for p in params.split(",")]
            for name, params in ENTRY.findall(src)}


@pytest.mark.parametrize("lib,name", ENTRIES,
                         ids=[name for _, name in ENTRIES])
def test_wrapper_signature_matches_the_c_declaration(lib, name):
    exports = _exports(lib)
    assert name in exports, f"{name} is not exported by csrc/{lib}.cu"
    assert list(LIBS[lib][name]) == exports[name]


@pytest.mark.parametrize("lib", list(LIBS))
def test_every_exported_entry_has_a_wrapper_signature(lib):
    assert sorted(_exports(lib)) == sorted(LIBS[lib])
