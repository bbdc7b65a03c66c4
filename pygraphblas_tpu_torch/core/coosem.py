"""Sorted-COO pair membership on the host, at the size the port needs so
far.

Counterpart of ``pygraphblas_tpu/core/coosem.py:29-78`` (``pairs``,
``pair_keys``, ``in_sorted``), which the unmasked SpGEMM's scipy tier
uses to re-fill pruned zeros.  The JAX package answers sorted queries
with its native dual-pointer pass (``_fastio``) when that is built; the
port always takes the binary searches, which give the same answer (as
``csrc/benes.cpp`` keeps its own copy of the routing, the port shares
no native module with the JAX package).

All functions take and return numpy arrays; rows and cols int64."""

import numpy as np

_PAIR_DTYPE = np.dtype([("r", np.int64), ("c", np.int64)])


def pairs(rows, cols):
    a = np.empty(len(rows), dtype=_PAIR_DTYPE)
    a["r"] = rows
    a["c"] = cols
    return a


def _key_shift(*col_arrays):
    """Bit width that packs (row, col) pairs into one int64 key, or None
    when the coordinates are too large (structured pairs then)."""
    cmax = 0
    for c in col_arrays:
        if len(c):
            cmax = max(cmax, int(c.max()))
    shift = max(1, int(cmax).bit_length())
    return shift if shift <= 31 else None


def _keys(r, c, shift):
    return (np.asarray(r, np.int64) << shift) | np.asarray(c, np.int64)


def pair_keys(ra, ca, rb, cb):
    """Comparable key arrays for two (row, col) pair sets: packed int64
    when the coordinates fit, structured pairs otherwise."""
    shift = _key_shift(ca, cb)
    if shift is not None and max(
            int(ra.max()) if len(ra) else 0,
            int(rb.max()) if len(rb) else 0).bit_length() + shift < 63:
        return _keys(ra, ca, shift), _keys(rb, cb, shift)
    return pairs(ra, ca), pairs(rb, cb)


def in_sorted(r, c, sr, sc):
    """Boolean membership of (r, c) pairs in the canonical pair set
    (sr, sc)."""
    if len(sr) == 0 or len(r) == 0:
        return np.zeros(len(r), bool)
    k, sk = pair_keys(r, c, sr, sc)
    pos = np.searchsorted(sk, k)
    pos_c = np.minimum(pos, len(sk) - 1)
    return (pos < len(sk)) & (sk[pos_c] == k)
