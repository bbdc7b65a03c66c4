"""Sorted-COO staging on the host.

Counterpart of ``pygraphblas_tpu/core/coosparse.py``: canonical
(row, col)-sorted, deduplicated int64 triples (``build``), pending-write
merges, lookups, element-wise merges and extraction.  The JAX
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


def merge_pending(rows, cols, vals, pend_rows, pend_cols, pend_vals, dtype):
    """Fold pending (later-wins) tuples into canonical COO."""
    all_r = np.concatenate([rows, np.asarray(pend_rows, np.int64)])
    all_c = np.concatenate([cols, np.asarray(pend_cols, np.int64)])
    all_v = np.concatenate([vals, np.asarray(pend_vals, dtype)])
    return build(all_r, all_c, all_v, dtype)


def find(rows, cols, i, j):
    """Index of entry (i, j) in canonical COO, or -1."""
    if rows.size == 0:
        return -1
    lo = np.searchsorted(rows, i, side="left")
    hi = np.searchsorted(rows, i, side="right")
    if lo == hi:
        return -1
    pos = lo + np.searchsorted(cols[lo:hi], j)
    if pos < hi and cols[pos] == j:
        return int(pos)
    return -1


def remove(rows, cols, vals, i, j):
    """Canonical COO without entry (i, j); the last item says whether it
    was there."""
    pos = find(rows, cols, i, j)
    if pos < 0:
        return rows, cols, vals, False
    keep = np.ones(rows.shape, bool)
    keep[pos] = False
    return rows[keep], cols[keep], vals[keep], True


def ewise(rows_a, cols_a, vals_a, rows_b, cols_b, vals_b, fn, dtype,
          union=True):
    """Element-wise union (eadd) or intersection (emult) of two canonical
    COOs; `fn` operates on numpy arrays of the matched entries."""
    from .coosem import pair_keys, union_merge, _merge_union_idx

    if union:
        return union_merge(rows_a, cols_a, vals_a, rows_b, cols_b,
                           vals_b, fn, dtype)
    if len(rows_a) == 0 or len(rows_b) == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, dtype)
    ka, kb = pair_keys(rows_a, cols_a, rows_b, cols_b)
    ia, ib = _merge_union_idx(ka, kb)
    both = (ia >= 0) & (ib >= 0)
    ai, bi = ia[both], ib[both]
    return (np.asarray(rows_a[ai], np.int64),
            np.asarray(cols_a[ai], np.int64),
            np.asarray(fn(vals_a[ai], vals_b[bi]), dtype))


def extract(rows, cols, vals, row_idx, col_idx):
    """The submatrix at (row_idx, col_idx) index vectors, renumbered to
    the output coordinate space."""
    row_idx = np.asarray(row_idx, np.int64)
    col_idx = np.asarray(col_idx, np.int64)
    rmap = {int(r): k for k, r in enumerate(row_idx)}
    cmap = {int(c): k for k, c in enumerate(col_idx)}
    out_r, out_c, out_v = [], [], []
    for r, c, v in zip(rows, cols, vals):
        ri = rmap.get(int(r))
        ci = cmap.get(int(c))
        if ri is not None and ci is not None:
            out_r.append(ri)
            out_c.append(ci)
            out_v.append(v)
    return (np.asarray(out_r, np.int64), np.asarray(out_c, np.int64),
            np.asarray(out_v, vals.dtype))
