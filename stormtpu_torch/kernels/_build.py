"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``kernels/build/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is not.

Nothing here runs at import time: the CPU tests import every module, and
there is no ``nvcc`` without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "SOURCES", "build_all", "kernel_resources", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_STR = ctypes.c_char_p
_F = ctypes.c_float

# source name → {C function: (argtypes, restype)}
SOURCES = {
    "k2_mxu": {
        "k2_block_rows": ((), _I),
        "k2_sub_tiles": ((_I,), _I),
        "k2_tri_launch": ((_VP, _VP, _VP, _VP, _I, _I, _LL, _VP), _I),
        "k2_rect_tma_launch": ((_VP, _VP, _VP, _LL, _LL, _LL, _LL, _I, _VP), _I),
        "k5_launch": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _LL, _VP), _I),
    },
    "tc_rate": {
        "tc_rate_kinds": ((), _I),
        "tc_rate_name": ((_I,), _STR),
        "tc_rate_threads": ((), _I),
        "tc_rate_macs": ((_I,), _LL),
        "tc_rate_launch": ((_I, _I, _I, _VP, _VP), _I),
    },
    "k2_epilogue": {
        "k2_epi_block_rows": ((), _I),
        "k2_epi_block_cols": ((), _I),
        "k2_topk_max_k": ((), _I),
        "k2_hist_max_bins": ((), _I),
        "k2_epi_cluster": ((_I,), _I),
        "k2_topk_launch": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _LL, _LL, _LL, _LL,
                            _LL, _I, _VP), _I),
        "k2_hist_launch": ((_VP, _VP, _VP, _VP, _I, _I, _LL, _LL, _LL, _LL, _LL, _I, _I, _VP),
                           _I),
    },
    "k1_dense": {
        "k1_block_rows": ((), _I),
        "k1_tri_launch": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _LL, _VP), _I),
        "k0_stream_launch": ((_VP, _VP, _VP, _LL, _LL, _I, _VP), _I),
    },
    "k4_sparse": {
        "k4_emit_warps_per_block": ((), _I),
        "k4_emit_launch": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _I, _VP, _LL, _VP), _I),
        "k4_mirror_launch": ((_VP, _VP, _LL, _LL, _VP), _I),
    },
    "stripe_screen": {
        "stripe_screen_launch": ((_VP, _LL, _I, _I, _VP, _VP, _LL, _I, _F, _F, _VP, _I, _VP),
                                 _I),
    },
}

# The sources the package's entry points launch. ``tc_rate`` is a measuring
# tool (``kernels/tc_rate.py``) and is built only for whoever asks for it.
KERNEL_SOURCES = ("k2_mxu", "k2_epilogue", "k1_dense", "k4_sparse", "stripe_screen")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
        "built from stormtpu_torch/kernels/csrc on first use"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns (target, process or None, temporary output path)."""
    so = _target(name)
    if so.exists():
        return so, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return so, proc, tmp


def _finish(name: str, so: Path, proc, tmp: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    so.with_suffix(".log").write_text(out)
    os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build the sources ``names`` that are not built yet, one ``nvcc`` per
    source, all started together. Returns {name: compiler output} for the
    sources built now (``-Xptxas -v`` register and spill report)."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        logs = {}
        for n, (so, proc, tmp) in started.items():
            _finish(n, so, proc, tmp)
            if proc is not None:
                logs[n] = so.with_suffix(".log").read_text()
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed, with ``argtypes``/``restype`` set for every C function."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so, proc, tmp = _start(name)
            _finish(name, so, proc, tmp)
            lib = ctypes.CDLL(str(so))
            for fn, (argtypes, restype) in SOURCES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _LIBS[name] = lib
        return lib


def kernel_resources(name: str) -> dict[str, dict[str, int]]:
    """{kernel symbol: {"registers", "spill_bytes", "smem_bytes"}} of
    ``csrc/<name>.cu`` as ``nvcc -Xptxas -v`` reported them when the
    library was built (static shared memory only). Builds it if needed."""
    library(name)
    out: dict[str, dict[str, int]] = {}
    symbol = None
    for line in _target(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            symbol = m.group(1)
            out[symbol] = {"registers": 0, "spill_bytes": 0, "smem_bytes": 0}
        elif symbol is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[symbol]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[symbol]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                out[symbol]["smem_bytes"] = int(m.group(1)) if m else 0
    return out
