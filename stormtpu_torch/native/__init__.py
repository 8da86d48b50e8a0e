"""ctypes binding of the port's C++ host tier (``packer.cpp``).

The port's copy of ``stormtpu/native``: packing, unpacking, row popcounts,
CSR extraction, one pair's count, and K4, the inverted-index all-pairs
count that runs on the host (``stpu_sparse_outer_*``, ``stpu_mirror_upper``).

Row popcounts, the CSR's first pass and one pair's count share one helper
in ``packer.cpp`` with three forms: AVX-512 VPOPCNTDQ, 64-bit POPCNT and a
portable loop. The library is built for the baseline target of its host
architecture, with the x86-64 forms compiled under ``target`` attributes,
and picks the best form the CPU reports once as it loads
(:func:`popcount_path`). Every form gives the same exact counts.

The library is built with ``g++`` at first use (the first call of an entry
point, of :func:`have_native` or of ``HAVE_NATIVE``; never at import) into
``native/build/`` under a name keyed by the source and the flags, so an
edited source is rebuilt. Several processes may start the build at once:
each takes an ``fcntl`` lock on ``build/.lock``, a process that finds the
library built loads it without compiling, and the compiler writes to a
temporary name that ``os.replace`` moves into place, so no process loads a
half-written file. A failed build is not retried in the same process; its
text is kept (:func:`native_build_error`).

Every entry point returns ``None`` (``mirror_upper_native``: ``False``)
when the library is unavailable; its callers then take their NumPy
fallback, which gives the same result (``layout.py``, ``kernels/sparse.py``).
``HAVE_NATIVE`` says which tier is active.

This module imports nothing of the package, so that it can be loaded alone.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "HAVE_NATIVE",
    "have_native",
    "native_build_error",
    "popcount_path",
    "library_path",
    "reset_launches",
    "pack_positions_native",
    "pack_bits_native",
    "unpack_bits_native",
    "row_popcounts_native",
    "positions_csr_native",
    "pair_count_native",
    "sparse_outer_from_packed_native",
    "sparse_outer_runs_native",
    "sparse_outer_runs_cross_native",
    "mirror_upper_native",
]

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "packer.cpp"
BUILD_DIR = _DIR / "build"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

# The library's popcount forms, by the code ``stpu_popcount_path`` returns.
POPCOUNT_PATHS = ("portable", "popcnt", "avx512_vpopcntdq")

# Runs of the K4 host kernel (``stpu_sparse_outer_*``) since the last reset.
LAUNCHES = {"k4": 0}

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False
_LOCK = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library for this source, compiler and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_compiler(),) + CXXFLAGS).encode())
    return BUILD_DIR / f"libstormtpu_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile ``packer.cpp`` into ``so`` unless another process has."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():
            return
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_compiler(), *CXXFLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, c_int = ctypes.c_int64, ctypes.c_int
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.stpu_pack_positions.restype = ctypes.c_int
    lib.stpu_pack_positions.argtypes = [p_i64, p_i64, i64, p_u32, i64, i64, i64]
    lib.stpu_pack_bits.restype = None
    lib.stpu_pack_bits.argtypes = [p_u8, i64, i64, p_u32, i64]
    lib.stpu_unpack_bits.restype = None
    lib.stpu_unpack_bits.argtypes = [p_u32, i64, i64, p_u8, i64]
    lib.stpu_row_popcounts.restype = None
    lib.stpu_row_popcounts.argtypes = [p_u32, i64, i64, p_i64]
    lib.stpu_positions_csr.restype = None
    lib.stpu_positions_csr.argtypes = [p_u32, i64, i64, i64, p_i64, ctypes.c_void_p]
    lib.stpu_pair_count.restype = i64
    lib.stpu_pair_count.argtypes = [p_u32, p_u32, i64]
    lib.stpu_popcount_path.restype = c_int
    lib.stpu_popcount_path.argtypes = []
    # the *_on forms and the support query serve the tests alone
    lib.stpu_popcount_path_supported.restype = c_int
    lib.stpu_popcount_path_supported.argtypes = [c_int]
    lib.stpu_row_popcounts_on.restype = c_int
    lib.stpu_row_popcounts_on.argtypes = [c_int, p_u32, i64, i64, p_i64]
    lib.stpu_positions_csr_on.restype = c_int
    lib.stpu_positions_csr_on.argtypes = [c_int, p_u32, i64, i64, i64, p_i64, ctypes.c_void_p]
    lib.stpu_pair_count_on.restype = i64
    lib.stpu_pair_count_on.argtypes = [c_int, p_u32, p_u32, i64]
    lib.stpu_sparse_outer_from_packed.restype = ctypes.c_int
    lib.stpu_sparse_outer_from_packed.argtypes = [p_u32, i64, i64, i64, p_i32]
    lib.stpu_mirror_upper.restype = None
    lib.stpu_mirror_upper.argtypes = [p_i32, i64]
    lib.stpu_sparse_outer_runs.restype = None
    lib.stpu_sparse_outer_runs.argtypes = [p_i64, p_i32, i64, i64, p_i32]
    lib.stpu_sparse_outer_runs_cross.restype = None
    lib.stpu_sparse_outer_runs_cross.argtypes = [
        p_i64, p_i32, i64, p_i64, p_i32, i64, i64, p_i32,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; ``None`` when the build
    or the load failed (the reason is in :func:`native_build_error`)."""
    global _lib, _error, _tried
    if _tried:
        return _lib
    with _LOCK:
        if not _tried:
            try:
                so = library_path()
                if not so.exists():
                    _build(so)
                _lib = _bind(ctypes.CDLL(str(so)))
            except (RuntimeError, OSError, AttributeError) as e:
                _error = f"{type(e).__name__}: {e}"
            _tried = True
    return _lib


def have_native() -> bool:
    """True when the C++ tier is built and loaded (building it if needed)."""
    return _load() is not None


def native_build_error() -> Optional[str]:
    """Why the C++ tier is unavailable (the compiler's or the loader's
    text), or ``None`` when it is loaded."""
    _load()
    return _error


def popcount_path() -> Optional[str]:
    """The popcount form the library runs on this CPU (one of
    :data:`POPCOUNT_PATHS`), or ``None`` when it is unavailable."""
    lib = _load()
    return None if lib is None else POPCOUNT_PATHS[lib.stpu_popcount_path()]


def __getattr__(name: str):
    if name == "HAVE_NATIVE":
        return have_native()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- ops
def pack_positions_native(
    rows: np.ndarray, pos: np.ndarray, n: int, m_bits: int, w: int
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    out = np.zeros((n, w), dtype=np.uint32)
    rc = lib.stpu_pack_positions(rows, pos, rows.size, out, n, m_bits, w)
    if rc != 0:
        raise ValueError("position or row id out of range")
    return out


def pack_bits_native(dense: np.ndarray, w: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    dense = np.ascontiguousarray(dense, dtype=np.uint8)
    n, m = dense.shape
    out = np.zeros((n, w), dtype=np.uint32)
    lib.stpu_pack_bits(dense, n, m, out, w)
    return out


def unpack_bits_native(packed: np.ndarray, m_bits: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    out = np.empty((n, m_bits), dtype=np.uint8)
    lib.stpu_unpack_bits(packed, n, w, out, m_bits)
    return out


def row_popcounts_native(packed: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    out = np.empty(n, dtype=np.int64)
    lib.stpu_row_popcounts(packed, n, w, out)
    return out


def positions_csr_native(
    packed: np.ndarray, m_bits: int
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(indptr int64 [N+1], indices int32 [nnz]) in two passes: the row
    counts, then the positions into a buffer of exactly nnz."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    indptr = np.zeros(n + 1, dtype=np.int64)
    lib.stpu_positions_csr(packed, n, w, m_bits, indptr, None)
    indices = np.empty(int(indptr[-1]), dtype=np.int32)
    lib.stpu_positions_csr(
        packed, n, w, m_bits, indptr, indices.ctypes.data_as(ctypes.c_void_p),
    )
    return indptr, indices


def sparse_outer_from_packed_native(
    packed: np.ndarray, m_bits: int
) -> Optional[np.ndarray]:
    """K4 straight from the packed words: int32 [N, N], the diagonal and
    the strict upper triangle filled (the caller mirrors)."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    n, w = packed.shape
    out = np.zeros((n, n), dtype=np.int32)
    LAUNCHES["k4"] += 1
    rc = lib.stpu_sparse_outer_from_packed(packed, n, w, m_bits, out)
    if rc != 0:
        raise ValueError("set bits beyond m_bits")
    return out


def sparse_outer_runs_native(
    col_ids: np.ndarray, rows: np.ndarray, n: int
) -> Optional[np.ndarray]:
    """K4 from column-sorted deduplicated COO (rows ascending within a
    column): int32 [n, n], diagonal and strict upper triangle."""
    lib = _load()
    if lib is None:
        return None
    col_ids = np.ascontiguousarray(col_ids, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    out = np.zeros((n, n), dtype=np.int32)
    LAUNCHES["k4"] += 1
    lib.stpu_sparse_outer_runs(col_ids, rows, col_ids.size, n, out)
    return out


def sparse_outer_runs_cross_native(
    cols_a: np.ndarray, rows_a: np.ndarray,
    cols_b: np.ndarray, rows_b: np.ndarray,
    na: int, nb: int,
) -> Optional[np.ndarray]:
    """K4 cross counts int32 [na, nb] from two column-sorted local-row COO
    lists (one stripe of the streamed walk)."""
    lib = _load()
    if lib is None:
        return None
    cols_a = np.ascontiguousarray(cols_a, dtype=np.int64)
    rows_a = np.ascontiguousarray(rows_a, dtype=np.int32)
    cols_b = np.ascontiguousarray(cols_b, dtype=np.int64)
    rows_b = np.ascontiguousarray(rows_b, dtype=np.int32)
    out = np.zeros((na, nb), dtype=np.int32)
    LAUNCHES["k4"] += 1
    lib.stpu_sparse_outer_runs_cross(
        cols_a, rows_a, cols_a.size, cols_b, rows_b, cols_b.size, nb, out,
    )
    return out


def mirror_upper_native(c: np.ndarray) -> bool:
    """Mirror the strict upper triangle of the square int32 ``c`` into the
    lower, in place; ``False`` when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    if c.dtype != np.int32 or not c.flags.c_contiguous or c.ndim != 2 \
            or c.shape[0] != c.shape[1]:
        raise ValueError("mirror_upper_native needs a square C-contiguous int32 array")
    lib.stpu_mirror_upper(c, c.shape[0])
    return True


def pair_count_native(a: np.ndarray, b: np.ndarray) -> Optional[int]:
    """popcount(a AND b) over two packed rows of equal length."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if a.size != b.size:
        raise ValueError(f"rows of {a.size} and {b.size} words")
    return int(lib.stpu_pair_count(a, b, a.size))
