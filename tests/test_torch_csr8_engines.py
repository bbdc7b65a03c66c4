"""The XLA-only engines as the containers and the fused loops reach
them, against the JAX package on the CPU: ``Matrix.mxv``/``Vector.vxm``
under ``spmv_engine`` "csr8" and "xspmv" on kron-12 (whose nnz passes
xspmv's MIN_NNZ), the async xspmv plan build under PageRank, the fused
loops' csr8 route below MIN_NNZ and under ``spmv_engine="csr8"``.  The
slowest cases of tests/test_torch_csr8.py, in a file of their own so
that the suite's workers run them beside its longest file.  Integer
results exactly; FP32 within rtol 1e-5."""

import time

import numpy as np
import pytest

import pygraphblas_tpu as J
from pygraphblas_tpu import fused as jfused, generators as jgen
import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch import fused, generators, types
from pygraphblas_tpu_torch.core import xspmv as TX


@pytest.fixture
def async_mode(tmp_path, monkeypatch):
    monkeypatch.setattr(TX, "PLAN_CACHE_DIR", str(tmp_path))
    T.options_set(spmv_plan_async=True)
    yield
    T.options_set(spmv_plan_async=False, bitmap_max_cells=1 << 26)


def _wait_plan(A, key, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if key in (A._ell_c or {}):
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def kron12():
    return generators.rmat_edges(12, 16)


def _engines(engine, cells):
    for pkg in (J, T):
        pkg.options_set(spmv_engine=engine, bitmap_max_cells=cells)


@pytest.mark.parametrize("engine", ["csr8", "xspmv"])
@pytest.mark.parametrize("sr,tdesc,vxm", [
    ("PLUS_TIMES", None, False), ("PLUS_SECOND", "T0", False),
    ("MIN_PLUS", None, True), ("MAX_FIRST", "T1", True)])
def test_mxv_engines_match_jax(kron12, engine, sr, tdesc, vxm):
    """Matrix.mxv / Vector.vxm on the COO tier with a dense x: csr8 and
    xspmv (the hand kernels' plain versions here) against the JAX
    package forced to the same engine, on kron-12 (nnz past MIN_NNZ)."""
    rows, cols, n = kron12
    rng = np.random.RandomState(2)
    vals = rng.uniform(0.5, 2.0, len(rows)).astype(np.float32)
    xv = rng.uniform(-1, 1, n).astype(np.float32)
    _engines(engine, 1 << 20)
    try:
        out = []
        for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
            A = pkg.generators.to_matrix(rows, cols, n, pkg.types.FP32,
                                         vals=vals, **kw)
            assert A._fmt == "coo" and A.nvals >= TX.MIN_NNZ
            x = pkg.Vector.from_numpy(xv, **kw)
            sem = getattr(pkg.types.FP32, sr)
            d = getattr(pkg.descriptor, tdesc) if tdesc else None
            y = x.vxm(A, semiring=sem, desc=d) if vxm else \
                A.mxv(x, semiring=sem, desc=d)
            out.append(y)
        want, got = out
        wi, wv = want.to_lists()
        gi, gv = got.to_lists()
        assert gi == wi
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)
        # the port's matrix (the last built) took the engine asked for
        assert any(k[0] == ("x" if engine == "xspmv" else "csr8")
                   for k in A._ell_c)
    finally:
        _engines("auto", 1 << 26)


def test_pagerank_async_plan_upgrade(async_mode):
    rows, cols, n = generators.rmat_edges(12, 16, seed=3)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    r1 = fused.pagerank(A, itermax=20, tol=0.0, device="cpu")  # COO loop
    key = ("x", True, np.dtype(np.float32).str)
    assert _wait_plan(A, key), "background plan build never landed"
    r2 = fused.pagerank(A, itermax=20, tol=0.0, device="cpu")  # xspmv
    assert ("x", True, np.dtype(np.float32).str, "cpu") in A._ell_c
    np.testing.assert_allclose(r1._vals.numpy(), r2._vals.numpy(),
                               rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("case", ["pagerank", "bfs_level", "bfs_batch",
                                  "sssp", "sssp_int", "bc"])
def test_fused_csr8_route_matches_jax(case):
    """Below MIN_NNZ the fused loops take the csr8 plan (bc: the
    container algorithm), in both packages.  Integer SSSP is held to the
    JAX loop on the same weights as FP32: the JAX package's own integer
    loop casts inf to the integer type and raises OverflowError."""
    rows, cols, n = generators.rmat_edges(8, 4)
    w = (np.arange(len(rows)) % 7 + 1).astype(np.float32)
    typ = "INT32" if case == "sssp_int" else "FP32"
    A = generators.to_matrix(rows, cols, n, getattr(types, typ), vals=w)
    jA = jgen.to_matrix(rows, cols, n, J.types.FP32, vals=w)
    assert A.nvals < TX.MIN_NNZ
    if case == "pagerank":
        got = fused.pagerank(A, device="cpu").to_numpy()
        want = np.asarray(jfused.pagerank(jA).to_numpy())
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    elif case == "bfs_level":
        assert fused.bfs_level(A, 0, device="cpu").to_lists() == \
            jfused.bfs_level(jA, 0).to_lists()
    elif case == "bfs_batch":
        got = fused.bfs_batch(A, [0, 5], device="cpu").numpy()
        assert np.array_equal(got, np.asarray(jfused.bfs_batch(jA, [0, 5])))
    elif case in ("sssp", "sssp_int"):
        got = fused.sssp(A, 0, device="cpu")
        want = jfused.sssp(jA, 0)
        gi, gv = got.to_lists()
        wi, wv = want.to_lists()
        assert gi == wi and np.array_equal(np.asarray(gv, np.float64),
                                           np.asarray(wv, np.float64))
    else:
        got = fused.bc(A, [0, 3], device="cpu").to_numpy()
        want = np.asarray(jfused.bc(jA, [0, 3]).to_numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_engine_choice_csr8():
    """spmv_engine="csr8" sends a graph past MIN_NNZ to the csr8 loops
    too; a non-square BC is the container algorithm in both packages."""
    rows, cols, n = generators.rmat_edges(12, 16)
    A = generators.to_matrix(rows, cols, n, types.FP32)
    jA = jgen.to_matrix(rows, cols, n, J.types.FP32)
    for pkg in (J, T):
        pkg.options_set(spmv_engine="csr8")
    try:
        got = fused.pagerank(A, itermax=10, device="cpu").to_numpy()
        want = np.asarray(jfused.pagerank(jA, itermax=10).to_numpy())
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert not any(k[0] == "x" for k in A._ell_c)
    finally:
        for pkg in (J, T):
            pkg.options_set(spmv_engine="auto")
    r = np.array([0, 0, 1, 2])
    c = np.array([1, 3, 2, 3])
    R = T.Matrix.sparse(types.FP32, 3, 4)
    R._build(r, c, np.ones(4, np.float32))
    jR = J.Matrix.sparse(J.types.FP32, 3, 4)
    jR._build(r, c, np.ones(4, np.float32))
    with pytest.raises(J.base.DimensionMismatch):
        jfused.bc(jR, [0])
    with pytest.raises(T.base.DimensionMismatch):
        fused.bc(R, [0], device="cpu")
