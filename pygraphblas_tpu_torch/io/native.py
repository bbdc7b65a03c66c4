"""ctypes wrapper over the native MatrixMarket parser and COO
canonicaliser (``csrc/fastio.cpp``, built with ``g++`` at first use by
``_native.build``).  ``available()`` says whether it can be built; once
asked for, a failed build raises."""

import ctypes

import numpy as np

from .. import _native

_lib = None


def available():
    """True when a C++ compiler is present (the library builds)."""
    return _native.available()


def lib():
    global _lib
    if _lib is None:
        L = ctypes.CDLL(_native.build("fastio.cpp"))
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        L.pgb_mm_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, p, p, p,
                                   p, p]
        L.pgb_mm_parse.restype = p
        L.pgb_mm_take.argtypes = [p, p, p, p]
        L.pgb_mm_take.restype = None
        L.pgb_sort_dedup.argtypes = [i64, p, p, p]
        L.pgb_sort_dedup.restype = i64
        _lib = L
    return _lib


def parse_mm_native(path):
    """Parse and canonicalise a MatrixMarket file with the C++ parser.

    Returns (rows, cols, vals, nrows, ncols, field_char): field 'p'
    (pattern: vals all True), 'i' (integer: vals int64, parsed exactly)
    or 'r' (float64); or None for a file the parser leaves to the Python
    reader (complex, hermitian, or an integer value that is not an int64
    literal)."""
    L = lib()
    nnz, nrows, ncols = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    field, err = ctypes.c_char(), ctypes.c_int()
    h = L.pgb_mm_parse(str(path).encode(), 1, ctypes.byref(nnz),
                       ctypes.byref(nrows), ctypes.byref(ncols),
                       ctypes.byref(field), ctypes.byref(err))
    if not h:
        if err.value == 1:
            raise FileNotFoundError(str(path))
        if err.value == 3:
            return None
        raise ValueError("bad MatrixMarket file")
    f = field.value.decode()
    rows = np.empty(nnz.value, np.int64)
    cols = np.empty(nnz.value, np.int64)
    vals = np.empty(nnz.value, np.int64 if f == "i" else np.float64)
    L.pgb_mm_take(h, rows.ctypes.data, cols.ctypes.data, vals.ctypes.data)
    if f == "p":
        vals = np.ones(len(rows), np.bool_)
    return rows, cols, vals, nrows.value, ncols.value, f


def sort_dedup_native(rows, cols, vals):
    """Canonicalise COO triples with the C++ radix sort (the last of
    duplicate entries kept); the sort carries each entry's index, so the
    values come back exactly, in their own dtype."""
    rows = np.array(rows, np.int64)
    cols = np.array(cols, np.int64)
    idx = None if vals is None else np.arange(len(rows), dtype=np.int64)
    n = lib().pgb_sort_dedup(len(rows), rows.ctypes.data, cols.ctypes.data,
                             None if idx is None else idx.ctypes.data)
    if idx is None:
        return rows[:n].copy(), cols[:n].copy(), None
    return rows[:n].copy(), cols[:n].copy(), np.asarray(vals)[idx[:n]]
