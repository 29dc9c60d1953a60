"""ctypes loader/builder for the native table generator (tablegen.cpp).

Compiles the shared library on first use (g++ -O3) next to this file and
caches it; `available()` gates use so matrix_fhe.tables transparently
falls back to the pure-Python builder (which is also the test oracle).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tablegen.cpp")
_SO = os.path.join(_HERE, "libtablegen.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_SO)
            lib.mf_vandermonde.argtypes = [
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64)]
            lib.mf_lagrange_inverse.argtypes = [
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.mf_find_eta.argtypes = [ctypes.c_uint64] * 4
            lib.mf_find_eta.restype = ctypes.c_uint64
            lib.mf_find_psi4n.argtypes = [ctypes.c_uint64] * 2
            lib.mf_find_psi4n.restype = ctypes.c_uint64
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def wcrt_tables(q: int, roots: Sequence[int], master: Sequence[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(V, V^-1) mod q for evaluation points `roots` of the monic `master`."""
    lib = _load()
    phi = len(roots)
    r = np.asarray(roots, dtype=np.uint64)
    m = np.asarray(master, dtype=np.int64)
    assert m.shape[0] == phi + 1
    v = np.empty((phi, phi), dtype=np.uint64)
    vi = np.empty((phi, phi), dtype=np.uint64)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.mf_vandermonde(q, r.ctypes.data_as(pu64), phi,
                       v.ctypes.data_as(pu64))
    lib.mf_lagrange_inverse(q, r.ctypes.data_as(pu64), phi,
                            m.ctypes.data_as(pi64),
                            vi.ctypes.data_as(pu64))
    return v, vi


def find_eta(q: int, p: int, f1: int, f2: int) -> int:
    lib = _load()
    out = lib.mf_find_eta(q, p, f1, f2)
    if out == 0:
        raise ValueError("native find_eta failed")
    return int(out)


def find_psi4n(q: int, n: int) -> int:
    lib = _load()
    out = lib.mf_find_psi4n(q, n)
    if out == 0:
        raise ValueError("native find_psi4n failed")
    return int(out)
