"""Host helpers of the sparse tier, at the size the port needs so far.

Counterpart of ``pygraphblas_tpu/core/sparse.py:59-87``
(``segment_fold_generic``), which the masked SpGEMM's heavy-edge host
fold uses.  It takes a numpy binary function where the JAX package takes
a monoid object."""

import numpy as np


def segment_fold_generic(ids_sorted, vals, add):
    """Segment reduce with the binary function `add` (numpy arrays in,
    numpy array out): ids sorted.  log(max segment) passes of vectorized
    adjacent-pair combining, so no identity value is needed.

    Returns (unique_ids, folded_vals)."""
    ids = np.asarray(ids_sorted)
    vals = np.asarray(vals)
    while len(ids):
        starts = np.ones(len(ids), bool)
        starts[1:] = ids[1:] != ids[:-1]
        if starts.all():
            break
        run_id = np.cumsum(starts) - 1
        run0 = np.zeros(run_id[-1] + 1, np.int64)
        run0[run_id[np.nonzero(starts)[0]]] = np.nonzero(starts)[0]
        within = np.arange(len(ids)) - run0[run_id]
        # pair each even-offset element with its odd-offset successor
        is_left = (within % 2 == 0)
        has_right = np.zeros(len(ids), bool)
        has_right[:-1] = is_left[:-1] & (~starts[1:])
        left = np.nonzero(has_right)[0]
        lone = np.nonzero(is_left & ~has_right)[0]
        merged = add(vals[left], vals[left + 1])
        keep_ids = np.concatenate([ids[left], ids[lone]])
        keep_vals = np.concatenate([np.asarray(merged, vals.dtype),
                                    vals[lone]])
        order = np.argsort(keep_ids, kind="stable")
        ids, vals = keep_ids[order], keep_vals[order]
    return ids, vals
