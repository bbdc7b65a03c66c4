"""Port parity for the container algorithms against the JAX package on
the CPU, on the bitmap and the COO tier (PageRank, SSSP, the BFS vxm
forms, the triangle methods, triangle and betweenness centrality), and
the device rules of the masked-SpGEMM algorithms.  ``masked_spgemm`` and
``triangle_count`` are in tests/test_torch_masked_spgemm.py, Louvain
and ``k_truss`` in tests/test_torch_louvain_truss.py.
"""

import numpy as np
import pytest
import torch

from pygraphblas_tpu import algorithms as jalg, generators as jgen
from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu_torch import algorithms, generators, types
from pygraphblas_tpu_torch.core import spgemm


def _sym(scale):
    rows, cols, n = generators.rmat_edges(scale, 16)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


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
