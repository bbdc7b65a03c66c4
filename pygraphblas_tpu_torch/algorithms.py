"""Graph algorithms over the masked SpGEMM, at the size the port needs
so far: triangle counting (method "sandia") and k-truss.

Counterparts of ``pygraphblas_tpu/algorithms.py:193-234``
(``triangle_count``) and ``296-328`` (``k_truss``): both run on
canonical host COO arrays feeding ``core/spgemm.py:masked_spgemm``
directly, with INT64 PLUS_PAIR.  Each runs on `device` (default
``cuda``; with no card and no device named it raises)."""

import time

import numpy as np

from . import types
from ._device import resolve_device
from .core import spgemm as gk
from .core.coosparse import build as _cbuild
from .matrix import Matrix

# host seconds by phase ("relabel+build") summed over calls since
# seconds.clear(); core/spgemm.stats holds masked_spgemm's own phases
seconds = {}


def triangle_count(A, method="sandia", order_by_degree=True, device=None):
    """Count triangles in the undirected graph A (boolean-symmetric):
    the sum of (L @ L)<L> with INT64 PLUS_PAIR, L the strict lower
    triangle.

    `order_by_degree` relabels vertices by ascending degree first (the
    GAP ordering): with power-law hubs the lower-triangle lists stay
    short, which bounds the per-edge intersection.  The count does not
    depend on the labels."""
    if method in ("cohen", "sandia_dot"):
        raise NotImplementedError(
            f"triangle_count method {method!r} needs Matrix.tril, triu and "
            "mxm: ROADMAP Queue A item 8")
    if method != "sandia":
        raise ValueError(f"unknown method {method}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    r, c, _ = A._coo()
    if order_by_degree:
        deg = np.bincount(r, minlength=max(A.nrows, A.ncols))
        perm = np.argsort(deg, kind="stable")
        rank = np.empty_like(perm)
        rank[perm] = np.arange(len(perm))
        r, c = rank[r], rank[c]
    keep = r > c
    lr, lc = r[keep], c[keep]
    ones = np.ones(len(lr), np.int64)
    lr, lc, ones = _cbuild(lr, lc, ones, np.int64)
    btr, btc, _ = _cbuild(lc, lr, ones, np.int64)
    gk.add_seconds(seconds, "relabel+build", t0)
    _, _, vv = gk.masked_spgemm(lr, lc, ones, btr, btc, ones, lr, lc,
                                types.INT64.PLUS_PAIR, np.int64, device=dev)
    return int(vv.sum())


def k_truss(A, k, device=None):
    """k-truss subgraph: every kept edge lies in >= k-2 triangles of
    the kept graph.  Returns an INT64 Matrix of the kept edges' supports
    (their triangle counts).

    Each pass is one masked PLUS_PAIR product C<A> = A @ A on the kept
    edges, which drops edges of no support, then a prune below k-2;
    passes end when a pass keeps every edge."""
    dev = resolve_device(device)
    r, c, _ = A._coo()
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    nvals_last = -1
    while True:
        t0 = time.perf_counter()
        ones = np.ones(len(r), np.int64)
        btr, btc, _ = _cbuild(c, r, ones, np.int64)
        gk.add_seconds(seconds, "relabel+build", t0)
        cnt_r, cnt_c, support = gk.masked_spgemm(
            r, c, ones, btr, btc, ones, r, c, types.INT64.PLUS_PAIR,
            np.int64, device=dev)
        keep = support >= (k - 2)
        r, c, support = cnt_r[keep], cnt_c[keep], support[keep]
        if len(r) == nvals_last:
            out = Matrix.sparse(types.INT64, A.nrows, A.ncols)
            out._build(r, c, support)
            return out
        nvals_last = len(r)
