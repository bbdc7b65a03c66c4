"""Port parity for the slice as a whole: masked_spgemm, triangle_count
and k_truss against the JAX package on the CPU, and their device rules.

masked_spgemm runs three ways: as the port runs on the CPU (the generic
intersect as torch ops), with the fused-path predicate made true so that
the plain versions of kernels 10 and 11 run through the full dispatch
(the pair path both fused and as the unfused chain of kernel 9), and
with WIDTH_CAP lowered in both packages so that the heavy host path
runs.  Rows and columns must be exact; values exact, or within rtol 1e-5
for float32 PLUS (another fold order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygraphblas_tpu import algorithms as jalg, generators as jgen
from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu.core import spgemm as jsg
from pygraphblas_tpu_torch import algorithms, generators, types
from pygraphblas_tpu_torch.core import spgemm

SEMIRINGS = [("PLUS_PAIR", "INT64"), ("PLUS_TIMES", "FP32"),
             ("MIN_PLUS", "INT32"), ("MAX_PAIR", "INT32")]
# PYGB_PAIR_FUSED=0 (the unfused chain) applies to the PAIR semirings only
CASES = [(sem, typ, case) for sem, typ in SEMIRINGS
         for case in ("as_is", "fast_fused", "fast_chain", "heavy")
         if case != "fast_chain" or sem.endswith("PAIR")]
HEAVY_CAP = 56


@pytest.fixture(scope="module")
def operands():
    """1500 vertices, about 30k random edges, values 1..5: A, B = A
    (given as A^T's rows) and the mask A."""
    rng = np.random.RandomState(2)
    n, nnz = 1500, 30000
    key = np.unique(rng.randint(0, n, nnz).astype(np.int64) * n
                    + rng.randint(0, n, nnz))
    r, c = key // n, key % n
    v = rng.randint(1, 6, len(r))
    order = np.lexsort((r, c))
    return r, c, v, c[order], r[order], v[order]


_JAX = {}


def _jax_result(operands, sem, typ, cap):
    key = (sem, typ, cap)
    if key not in _JAX:
        r, c, v, btr, btc, btv = operands
        dt = getattr(types, typ).numpy_dtype
        saved = jsg.WIDTH_CAP
        jsg.WIDTH_CAP = cap
        try:
            _JAX[key] = jsg.masked_spgemm(
                r, c, v.astype(dt), btr, btc, btv.astype(dt), r, c,
                getattr(getattr(jtypes, typ), sem.lower()), dt)
        finally:
            jsg.WIDTH_CAP = saved
    return _JAX[key]


@pytest.mark.parametrize("sem,typ,case", CASES)
def test_masked_spgemm_matches_jax(operands, sem, typ, case, monkeypatch):
    r, c, v, btr, btc, btv = operands
    dt = getattr(types, typ).numpy_dtype
    cap = HEAVY_CAP if case == "heavy" else spgemm.WIDTH_CAP
    want = _jax_result(operands, sem, typ, cap)
    if case == "heavy":
        monkeypatch.setattr(spgemm, "WIDTH_CAP", cap)
        total = np.bincount(r)[r] + np.bincount(c)[c]
        assert 0 < (total > cap).sum() < len(r) // 2
    if case.startswith("fast"):
        monkeypatch.setattr(spgemm, "_fast_paths", lambda dev: True)
        monkeypatch.setenv("PYGB_PAIR_FUSED",
                           "1" if case == "fast_fused" else "0")
    calls = dict.fromkeys(("pair_count", "fill_keys", "pair_fold"), 0)
    for name in calls:
        def counted(*a, _name=name, _orig=getattr(spgemm, name)):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(spgemm, name, counted)
    spgemm.reset_stats()
    got = spgemm.masked_spgemm(r, c, v.astype(dt), btr, btc, btv.astype(dt),
                               r, c, getattr(getattr(types, typ), sem), dt,
                               device="cpu")
    if case.startswith("fast"):
        kernel = ("pair_fold" if "PAIR" not in sem else
                  "pair_count" if case == "fast_fused" else "fill_keys")
        assert calls[kernel] > 0
        assert sum(calls.values()) == calls[kernel]
    else:
        assert sum(calls.values()) == 0
    assert spgemm.stats["heavy_edges"] == ((total > cap).sum()
                                           if case == "heavy" else 0)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2].dtype == np.dtype(dt)
    if typ == "FP32" and sem.startswith("PLUS"):
        np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-5)
    else:
        assert np.array_equal(got[2], np.asarray(want[2]))


def _sym(scale):
    rows, cols, n = generators.rmat_edges(scale, 16)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


@pytest.mark.parametrize("scale", [10, 12])
def test_triangle_count_matches_jax_and_scipy(scale):
    rows, cols, n = _sym(scale)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    got = algorithms.triangle_count(A, device="cpu")
    want = jalg.triangle_count(jgen.to_matrix(rows, cols, n))
    L = sp.tril(sp.csr_matrix((np.ones(len(rows)), (rows, cols)), (n, n)),
                -1).tocsr()
    assert got == want == int((L @ L).multiply(L).sum())
    assert got > 0


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


def test_other_triangle_methods_raise():
    """"cohen" and "sandia_dot" run through the containers (tril, triu
    and a masked mxm) and give the "sandia" count; an unknown method
    still raises."""
    rows, cols, n = _sym(6)
    A = generators.to_matrix(rows, cols, n)
    want = algorithms.triangle_count(A, device="cpu")
    assert want > 0
    for method in ("cohen", "sandia_dot"):
        assert algorithms.triangle_count(A, method=method,
                                         device="cpu") == want
    with pytest.raises(ValueError):
        algorithms.triangle_count(A, method="nope", device="cpu")


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


def _dense(v):
    """A vector's values as a dense float64 array (absent: 0), from its
    index and value lists (a COO-tier vector has no dense copy)."""
    out = np.zeros(v.size)
    i, x = v.to_lists()
    out[i] = x
    return out


def _pair(rows, cols, n, tname="FP32", vals=None):
    typ, jtyp = getattr(types, tname), getattr(jtypes, tname)
    return (generators.to_matrix(rows, cols, n, typ, vals=vals,
                                 device="cpu"),
            jgen.to_matrix(rows, cols, n, jtyp, vals=vals))


@pytest.mark.parametrize("method", ["cohen", "sandia_dot"])
@pytest.mark.parametrize("order", [True, False])
def test_triangle_methods_match_jax(tier, method, order):
    rows, cols, n = _sym(7)
    A, jA = _pair(rows, cols, n)
    got = algorithms.triangle_count(A, method=method, order_by_degree=order)
    want = jalg.triangle_count(jA, method=method, order_by_degree=order)
    assert got == want > 0


def test_pagerank_container_matches_jax(tier):
    """The GAP formulation through mxv(desc=T0, accum=PLUS), 10
    iterations: within 1e-5 x the largest rank."""
    rows, cols, n = generators.rmat_edges(7, 8)
    A, jA = _pair(rows, cols, n)
    got = algorithms.pagerank(A, itermax=10, tol=-1.0)
    want = jalg.pagerank(jA, itermax=10, tol=-1.0)
    assert got.to_lists()[0] == want.to_lists()[0]
    g, w = _dense(got), _dense(want)
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("tname", ["FP32", "INT32"])
def test_sssp_container_matches_jax(tier, tname):
    rows, cols, n = generators.rmat_edges(7, 8)
    w = (np.arange(len(rows)) % 9 + 1).astype(np.float32)
    A, jA = _pair(rows, cols, n, tname, vals=w)
    got = algorithms.sssp(A, 0)
    want = jalg.sssp(jA, 0)
    assert got.to_lists() == want.to_lists()
    assert got.nvals > 1


def test_bfs_vxm_match_jax(tier):
    rows, cols, n = generators.rmat_edges(7, 8)
    A, jA = _pair(rows, cols, n, "BOOL")
    got = algorithms.bfs_level_vxm(A, 0)
    assert got.to_lists() == jalg.bfs_level_vxm(jA, 0).to_lists()
    par = algorithms.bfs_parents_vxm(A, 0)
    jpar = jalg.bfs_parents_vxm(jA, 0)
    # ANY_SECONDI: any parent one level up will do -- the same tree
    # pattern, and each parent an in-neighbour one level closer
    assert par.to_lists()[0] == jpar.to_lists()[0]
    lv = dict(zip(*got.to_lists()))
    edges = set(zip(rows.tolist(), cols.tolist()))
    for v, p in zip(*par.to_lists()):
        assert v == 0 or ((p, v) in edges and lv[p] == lv[v] - 1)


def test_triangle_centrality_matches_jax(tier):
    rows, cols, n = _sym(6)
    A, jA = _pair(rows, cols, n)
    got = _dense(algorithms.triangle_centrality(A))
    want = _dense(jalg.triangle_centrality(jA))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_betweenness_centrality_matches_jax(tier):
    rows, cols, n = generators.rmat_edges(6, 8)
    A, jA = _pair(rows, cols, n)
    got = _dense(algorithms.betweenness_centrality(A, [0, 3]))
    want = _dense(jalg.betweenness_centrality(jA, [0, 3]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rows, cols, n = _sym(6)
    A = generators.to_matrix(rows, cols, n)
    r, c, v = A._coo()
    with pytest.raises(RuntimeError, match="CUDA"):
        algorithms.triangle_count(A)
    with pytest.raises(RuntimeError, match="CUDA"):
        algorithms.k_truss(A, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        spgemm.masked_spgemm(r, c, v, c, r, v, r, c, types.FP32.PLUS_TIMES,
                             np.float32)


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
