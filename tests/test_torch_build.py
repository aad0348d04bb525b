"""The binding between the port's wrappers and its CUDA libraries, on the
CPU: `_build.ENTRY_POINTS` against what each `csrc/*.cu` exports (every
`extern "C"` function typed once, as its C signature says, and nothing
else; the error decoder only in the shared header), `load`'s typing on a
stand-in library, and `check`'s message."""

import ctypes
import os
import re
import types

import pytest

from deepxi_tpu_torch.ops.kernels import _build

SOURCES = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
HEADER = os.path.join(_build.CSRC_DIR, "deepxi_error.cuh")

# C types as the sources spell them -> the ctypes type the table gives them
C_TYPES = {
    "int": ctypes.c_int, "int*": ctypes.POINTER(ctypes.c_int),
    "const int*": ctypes.POINTER(ctypes.c_int), "float": ctypes.c_float,
    "long long": ctypes.c_longlong, "long long*": ctypes.POINTER(ctypes.c_longlong),
    "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
    "const void* const*": ctypes.POINTER(ctypes.c_void_p),
    "unsigned long long*": ctypes.c_void_p, "const char*": ctypes.c_char_p,
}
_DEF = re.compile(r"^([A-Za-z_][\w \*]*?)\s*\b(\w+)\(([^)]*)\)\s*\{", re.M)


def _signatures(text: str):
    """name -> (restype, argtypes) of each function defined in `text`."""
    out = {}
    for ret, name, params in _DEF.findall(text):
        types_ = [re.sub(r"\s*\*", "*", re.sub(r"\s*\w+$", "", p.strip()))
                  for p in params.split(",") if p.strip()]
        out[name] = (C_TYPES[ret.strip()], [C_TYPES[t] for t in types_])
    return out


def _exports(name: str):
    with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as f:
        text = f.read()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    return text, _signatures(block)


@pytest.mark.parametrize("name", SOURCES)
def test_the_table_types_every_export_once_and_one_header_decodes_errors(name):
    """Every function of the source's `extern "C"` block has one entry in
    the table, under this source and no other, with its C signature's types;
    the table names nothing the source does not export. The source decodes
    no error of its own: it includes the shared header, whose decoder every
    load types."""
    text, exports = _exports(name)
    assert exports == _build.ENTRY_POINTS[name]
    others = [fn for src, table in _build.ENTRY_POINTS.items() if src != name for fn in table]
    assert not set(exports) & set(others)
    assert not [fn for fn in exports if "error" in fn]
    assert '#include "deepxi_error.cuh"' in text
    with open(HEADER) as f:
        assert _signatures(f.read().replace('extern "C" ', "")) == _build._DECODER


def test_load_types_what_a_build_exports(monkeypatch):
    """`load` types each entry point the library has, the decoder too, and
    leaves one that this build does not compile (masked_lstm_phases outside
    LSTM_PHASES builds) alone; a hit hands back the same library."""
    present = ["deepxi_error_string", *(fn for fn in _build.ENTRY_POINTS["lstm"]
                                        if fn != "masked_lstm_phases")]
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda specs: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        **{fn: types.SimpleNamespace() for fn in present}))
    lib = _build.load("lstm", {"LSTM_FWD_TC_ROWS": 1})
    assert _build.load("lstm", {"LSTM_FWD_TC_ROWS": 1}) is lib
    assert not hasattr(lib, "masked_lstm_phases")
    table = {**_build._DECODER, **_build.ENTRY_POINTS["lstm"]}
    for fn in present:
        assert (getattr(lib, fn).restype, getattr(lib, fn).argtypes) == table[fn], fn


def test_check_names_the_launch_the_code_and_its_text():
    lib = types.SimpleNamespace(
        deepxi_error_string=lambda rc: {720: b"too many blocks in cooperative launch"}[rc])
    _build.check(lib, 0, "masked_lstm_forward")
    with pytest.raises(RuntimeError) as err:
        _build.check(lib, 720, "masked_lstm_forward at [T, B, H] = [4, 33, 1024]")
    assert str(err.value) == ("masked_lstm_forward at [T, B, H] = [4, 33, 1024] failed: "
                              "error 720 (too many blocks in cooperative launch)")
