"""Sorted-COO staging on the host, at the size the port needs so far.

Counterpart of ``pygraphblas_tpu/core/coosparse.py:27-65`` (``build``):
canonical (row, col)-sorted, deduplicated int64 triples.  The JAX
package sends large builds to its native radix sort when that is built;
it gives the same triples as the ``np.lexsort`` here, which the port
always takes."""

import numpy as np


def build(rows, cols, vals, dtype):
    """Sort by (row, col) and deduplicate (later duplicates win);
    returns canonical COO triples."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, dtype)
    if rows.size <= 1:
        return rows, cols, vals
    # already canonical (strictly (row, col)-sorted, no duplicates): the
    # common case for op results, which inherit the sorted mask order;
    # the O(n) check skips the O(n log n) sort
    rs, cs = rows[1:], cols[1:]
    rp, cp = rows[:-1], cols[:-1]
    if bool(np.all((rs > rp) | ((rs == rp) & (cs > cp)))):
        return rows, cols, vals
    order = np.lexsort((cols, rows))  # stable, row-major
    rows = rows[order]
    cols = cols[order]
    vals = vals[order]
    uniq = np.empty(rows.shape, bool)
    uniq[:-1] = (rows[:-1] != rows[1:]) | (cols[:-1] != cols[1:])
    uniq[-1] = True
    return rows[uniq], cols[uniq], vals[uniq]
