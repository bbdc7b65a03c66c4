"""Louvain and k-truss of the port against the JAX package on the CPU:
the slowest cases of tests/test_torch_algorithms.py, in a file of their
own so that the suite's workers run them beside its longest file.
``louvain_cluster``'s labels equal the JAX package's on the two-block
graph and a 400-vertex planted partition, on both tiers; ``k_truss``'s
edges and supports equal."""

import numpy as np
import pytest

from pygraphblas_tpu import algorithms as jalg, generators as jgen
from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu_torch import algorithms, generators, types


def _sym(scale):
    rows, cols, n = generators.rmat_edges(scale, 16)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


@pytest.mark.parametrize("k", [3, 4])
def test_k_truss_matches_jax(k):
    rows, cols, n = _sym(10)
    got = algorithms.k_truss(generators.to_matrix(rows, cols, n), k,
                             device="cpu")
    want = jalg.k_truss(jgen.to_matrix(rows, cols, n), k)
    assert got.type is types.INT64
    (gr, gc, gv), (wr, wc, wv) = got._coo(), want._coo()
    assert np.array_equal(gr, wr) and np.array_equal(gc, wc)
    assert np.array_equal(gv, np.asarray(wv))
    assert 0 < len(gr) < len(rows) and gv.min() >= k - 2


@pytest.fixture(params=["bitmap", "coo"])
def tier(request):
    """Both packages on the bitmap tier, or on the forced COO tier
    (bitmap_max_cells = vector_max_cells = 1), restored after."""
    import pygraphblas_tpu as J
    import pygraphblas_tpu_torch as T

    small = request.param == "coo"
    for pkg in (J, T):
        pkg.options_set(bitmap_max_cells=1 if small else 1 << 26,
                        vector_max_cells=1 if small else 1 << 27)
    try:
        yield request.param
    finally:
        for pkg in (J, T):
            pkg.options_set(bitmap_max_cells=1 << 26,
                            vector_max_cells=1 << 27)


def _two_blocks():
    """tests/test_algorithms.py's graph: two blocks of 30 (p 0.5 inside,
    0.02 across), weights 1."""
    import networkx as nx

    G = nx.random_partition_graph([30, 30], 0.5, 0.02, seed=1)
    e = np.asarray(list(G.edges()), np.int64)
    r = np.concatenate([e[:, 0], e[:, 1]])
    c = np.concatenate([e[:, 1], e[:, 0]])
    return r, c, np.ones(len(r)), 60


def _planted():
    """A planted partition: 400 vertices in 8 groups (p 0.1 inside, 0.005
    across), symmetric integer weights 1..3 (every sum exact in FP32)."""
    rng = np.random.RandomState(3)
    n = 400
    group = rng.randint(0, 8, n)
    p = np.where(group[:, None] == group[None, :], 0.1, 0.005)
    W = np.triu((rng.rand(n, n) < p) * rng.randint(1, 4, (n, n)), 1)
    W = W + W.T
    r, c = np.nonzero(W)
    return r.astype(np.int64), c.astype(np.int64), \
        W[r, c].astype(np.float64), n


LOUVAIN_GRAPHS = {"two_blocks": _two_blocks, "planted400": _planted}
_JAX_LABELS = {}


@pytest.mark.parametrize("graph", sorted(LOUVAIN_GRAPHS))
def test_louvain_matches_jax(tier, graph):
    """louvain_cluster's labels equal the JAX package's.  The JAX labels
    are computed once a graph, on the first tier that asks (they are the
    same on both tiers: the chunk products are exact integer sums)."""
    import pygraphblas_tpu as J

    r, c, v, n = LOUVAIN_GRAPHS[graph]()
    if graph not in _JAX_LABELS:
        jA = J.Matrix.sparse(jtypes.FP64, n, n)
        jA._build(r, c, v)
        _JAX_LABELS[graph] = jalg.louvain_cluster(jA).to_lists()
    A = algorithms.Matrix.sparse(types.FP64, n, n, device="cpu")
    A._build(r, c, v)
    algorithms.seconds.clear()
    got = algorithms.louvain_cluster(A, device="cpu")
    assert got.to_lists() == _JAX_LABELS[graph]
    assert set(algorithms.seconds) == {"louvain extract", "louvain mxm",
                                       "louvain moves", "louvain contract"}
    labels = np.asarray(got.to_lists()[1])
    if graph == "two_blocks":
        a, b = np.bincount(labels[:30]).argmax(), \
            np.bincount(labels[30:]).argmax()
        assert a != b and (labels[:30] == a).sum() >= 27 \
            and (labels[30:] == b).sum() >= 27
