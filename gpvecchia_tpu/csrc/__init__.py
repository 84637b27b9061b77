"""Native host-ops: build-on-demand ctypes bindings with NumPy fallbacks.

The shared library is compiled from hostops.cpp on first use (g++ -O3
-march=native, for the machine that runs it) into a file named by a hash of
the source, so an edited source is always rebuilt and a library built
elsewhere is never loaded; the build output is not tracked by git.  If
compilation fails (no toolchain), callers fall back to the pure-NumPy
implementations in gpvecchia_tpu.geometry / gpvecchia_tpu.symbolic;
`require_lib()` turns that fallback into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostops.cpp")
_lock = threading.Lock()
_lib = None
_tried = False
_error = None


def _lib_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, f"libhostops-{digest}.so")


def _build(path):
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, path)       # atomic: concurrent builders never see half


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.maxmin_exact.argtypes = [f64p, ctypes.c_int64, ctypes.c_int, i64p]
            lib.ordered_nn.argtypes = [f64p, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int, i64p]
            lib.sgv_select.argtypes = [i64p, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_int64, u8p]
            lib.mra_tree.argtypes = [f64p, ctypes.c_int64, ctypes.c_int,
                                     i64p, i64p, ctypes.c_int64, i64p, i64p,
                                     i64p]
            lib.symbolic_chol_count.argtypes = [i64p, i64p, ctypes.c_int64,
                                                i64p, i64p]
            lib.symbolic_chol_count.restype = ctypes.c_int64
            lib.symbolic_chol_fill.argtypes = [i64p, i64p, ctypes.c_int64,
                                               i64p, i64p, i64p]
            lib.solve_levels_fwd.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
            lib.solve_levels_bwd.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
            _lib = lib
        except Exception as e:
            _lib = None
            _error = e
        return _lib


def require_lib():
    """The native library, or RuntimeError if it cannot be built/loaded."""
    lib = get_lib()
    if lib is None:
        detail = getattr(_error, "stderr", b"") or b""
        raise RuntimeError(
            f"native host library unavailable ({_error!r}): "
            f"{detail.decode(errors='replace')[-2000:]}")
    return lib


def maxmin_exact(locs: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    locs = np.ascontiguousarray(locs, dtype=np.float64)
    n, d = locs.shape
    out = np.empty(n, dtype=np.int64)
    lib.maxmin_exact(locs, n, d, out)
    return out


def ordered_nn(locsord: np.ndarray, m: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    locs = np.ascontiguousarray(locsord, dtype=np.float64)
    n, d = locs.shape
    m = int(min(m, n - 1))
    NN = np.empty((n, m + 1), dtype=np.int64)
    lib.ordered_nn(locs, n, d, m, NN)
    return NN


def sgv_select(NN: np.ndarray, first_pred: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    NN = np.ascontiguousarray(NN, dtype=np.int64)
    n, mp1 = NN.shape
    cond = np.empty((n, mp1), dtype=np.uint8)
    lib.sgv_select(NN, n, mp1, first_pred, cond)
    return cond.astype(bool)


def mra_tree(locsord: np.ndarray, J, M: int, r):
    """Native MRA knot-tree chains; None if the lib is unavailable.

    Returns (chain_next, chain_len, eff_dict) matching the Python BFS in
    geometry/mra.py (reference: src/fastTree.cpp:272-297).
    """
    lib = get_lib()
    if lib is None:
        return None
    locs = np.ascontiguousarray(locsord, dtype=np.float64)
    n, d = locs.shape
    J = np.ascontiguousarray(J, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    chain_next = np.empty(n, dtype=np.int64)
    chain_len = np.empty(n, dtype=np.int64)
    eff = np.empty(M + 4, dtype=np.int64)
    lib.mra_tree(locs, n, d, J, r, M, chain_next, chain_len, eff)
    eff_M, finest_count, finest_total = int(eff[0]), int(eff[1]), int(eff[2])
    eff_r = eff[3:3 + M + 1].tolist()
    if finest_count > 0:
        eff_r[M] = finest_total // finest_count
    return chain_next, chain_len, {
        "M": eff_M, "r": eff_r}


def symbolic_chol(indptr: np.ndarray, indices: np.ndarray, n: int):
    """(col_arrays, parent, row_level) or None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    colcount = np.empty(n, dtype=np.int64)
    lib.symbolic_chol_count(indptr, indices, n, parent, colcount)
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=colptr[1:])
    rows = np.empty(colptr[-1], dtype=np.int64)
    row_level = np.empty(n, dtype=np.int64)
    lib.symbolic_chol_fill(indptr, indices, n, colptr, rows, row_level)
    col_arrays = [rows[colptr[j]:colptr[j + 1]] for j in range(n)]
    return col_arrays, parent, row_level


def symbolic_chol_flat(indptr: np.ndarray, indices: np.ndarray, n: int):
    """(colptr, rows, row_level) CSC of the Cholesky fill; None w/o lib."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    colcount = np.empty(n, dtype=np.int64)
    lib.symbolic_chol_count(indptr, indices, n, parent, colcount)
    colptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=colptr[1:])
    rows = np.empty(colptr[-1], dtype=np.int64)
    row_level = np.empty(n, dtype=np.int64)
    lib.symbolic_chol_fill(indptr, indices, n, colptr, rows, row_level)
    return colptr, rows, row_level


def solve_levels(colptr: np.ndarray, rows: np.ndarray, n: int,
                 direction: str):
    """Per-column dependency levels of a triangular solve; None w/o lib."""
    lib = get_lib()
    if lib is None:
        return None
    colptr = np.ascontiguousarray(colptr, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    level = np.empty(n, dtype=np.int64)
    if direction == "fwd":
        lib.solve_levels_fwd(colptr, rows, n, level)
    else:
        lib.solve_levels_bwd(colptr, rows, n, level)
    return level
