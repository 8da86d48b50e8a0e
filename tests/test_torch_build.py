"""The C interface of the port's CUDA sources against the ``ctypes``
table that loads them (``stormtpu_torch.kernels._build.SOURCES``), read
from the sources' text, on the CPU (there is no compiler here).

Every name listed for ``csrc/<name>.cu`` is defined in that file's
``extern "C"`` block with as many parameters as its ``argtypes``, each of
the type ``ctypes`` will pass (a pointer as ``c_void_p``, ``long long``
as ``c_longlong``, ``int`` as ``c_int``, ``float`` as ``c_float``), and
every ``extern "C"`` function there is listed. A missing or short ``argtypes`` entry makes
``ctypes`` pass a pointer or a 64-bit integer as a 32-bit int."""

import ctypes
import re

import pytest

from stormtpu_torch.kernels import _build


def _c_functions(name: str) -> dict:
    """{function: (return type, [parameter types])} of the ``extern "C"``
    block of ``csrc/<name>.cu``."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    start = text.index('extern "C" {') + len('extern "C" {')
    depth, body = 0, []
    for i in range(start, len(text)):  # the block's top level only
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            if depth == 0:
                break
            depth -= 1
        elif depth == 0:
            body.append(c)
    out = {}
    for m in re.finditer(r"([A-Za-z_][\w\s\*]*?)\b(\w+)\s*\(([^()]*)\)\s*$",
                         "".join(body), flags=re.M):
        ret, fn, params = m.group(1).strip(), m.group(2), m.group(3).strip()
        types = [] if params in ("", "void") else [_param_type(p) for p in params.split(",")]
        out[fn] = (ret, types)
    return out


def _param_type(param: str) -> str:
    """The type of one C parameter, named or not (``long long w``,
    ``long long``, ``const void* packed``)."""
    words = " ".join(param.split())
    if words.endswith("*") or words.split()[-1] in ("int", "long", "char", "void"):
        return words
    return words.rsplit(" ", 1)[0]


def _ctype(c_type: str):
    if "*" in c_type:
        return ctypes.c_char_p if c_type.replace(" ", "") == "constchar*" else ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[" ".join(c_type.split())]


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_ctypes_table_matches_the_extern_c_block(name):
    defined = _c_functions(name)
    listed = _build.SOURCES[name]
    assert set(defined) == set(listed), (name, set(defined) ^ set(listed))
    for fn, (argtypes, restype) in listed.items():
        ret, params = defined[fn]
        assert len(argtypes) == len(params), (fn, params)
        assert [_ctype(p) for p in params] == list(argtypes), (fn, params)
        assert _ctype(ret) == restype, (fn, ret)


def test_every_kernel_source_is_in_the_table():
    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert on_disk == set(_build.SOURCES)
    assert set(_build.KERNEL_SOURCES) <= on_disk

