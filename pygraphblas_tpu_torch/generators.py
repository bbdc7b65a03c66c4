"""Synthetic graph generators (GAP-style workload inputs).

RMAT/Kronecker power-law graphs (the "kron" GAP input family) and
uniform-random ("urand") graphs, generated vectorized on the host.  The
edge lists equal those of ``pygraphblas_tpu.generators`` for the same
seed (same numpy RandomState draws in the same order).
"""

import numpy as np

__all__ = ["rmat_edges", "urand_edges", "to_matrix", "unique_keys"]


def unique_keys(keys):
    """``np.unique(keys)`` of a 1-d integer array, by one sort: numpy
    2.3's ``np.unique`` hashes, and took 41.4 s for 16M int64 keys where
    ``np.sort`` took 0.28 s (numpy 2.3.5 on the host of an NVIDIA H100
    80GB HBM3 machine)."""
    keys = np.sort(keys)
    if len(keys):
        keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    return keys


def rmat_edges(scale, edgefactor=16, a=0.57, b=0.19, c=0.19, seed=42,
               dedup=True):
    """Generate an RMAT (Graph500-style) edge list: 2^scale vertices,
    edgefactor * 2^scale directed edges (before dedup)."""
    rng = np.random.RandomState(seed)
    n = 1 << scale
    m = edgefactor << scale
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    ab = a + b
    c_norm = c / (1 - ab)
    a_norm = a / ab
    for bit in range(scale):
        r_bit = rng.rand(m) > ab
        c_bit = np.where(
            r_bit,
            rng.rand(m) > c_norm,
            rng.rand(m) > a_norm,
        )
        rows |= (r_bit.astype(np.int64) << bit)
        cols |= (c_bit.astype(np.int64) << bit)
    # permute vertex ids to remove locality
    perm = rng.permutation(n)
    rows = perm[rows]
    cols = perm[cols]
    if dedup:
        rows, cols = _dedup(rows, cols, scale)
    return rows, cols, n


def _dedup(rows, cols, scale):
    """Drop self-loops + duplicate edges (unique on packed keys)."""
    keep = rows != cols
    if scale > 31:          # packed keys would overflow int64
        return rows[keep], cols[keep]
    keys = unique_keys((rows[keep] << scale) | cols[keep])
    return keys >> scale, keys & ((np.int64(1) << scale) - 1)


def urand_edges(scale, edgefactor=16, seed=42, dedup=True):
    """Uniform-random directed edges: 2^scale vertices."""
    rng = np.random.RandomState(seed)
    n = 1 << scale
    m = edgefactor << scale
    rows = rng.randint(0, n, m)
    cols = rng.randint(0, n, m)
    if dedup:
        rows, cols = _dedup(rows, cols, scale)
    return rows, cols, n


def to_matrix(rows, cols, n, typ=None, vals=None, device=None):
    """Build a Matrix from an edge list (on `device`, or on the device of
    its first device work; see ``Matrix``)."""
    from . import types
    from .matrix import Matrix

    if typ is None:
        typ = types.FP32
    A = Matrix.sparse(typ, n, n, device=device)
    if vals is None:
        vals = np.ones(len(rows), typ.numpy_dtype)
    A._build(np.asarray(rows), np.asarray(cols), vals)
    return A
