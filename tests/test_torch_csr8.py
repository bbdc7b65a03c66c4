"""Port parity for the sparse tier's XLA-only engines: the csr8 gather
pyramid (``core/csr8.py``), SpMSpV (``core/spmspv.py``), the COO segment
reductions and SpMV (``core/sparse.py``) and the device element-wise
engine (``core/dewise.py``), each against its JAX twin on the same
inputs made from a numpy seed, on the CPU; then the async xspmv plan
build under ``Matrix.mxv`` and its stale writes (as
``tests/test_async_plan.py`` holds the JAX package's).  The engines as
the containers and the fused loops reach them are in
tests/test_torch_csr8_engines.py.  Integer and boolean results exactly;
FP32 folds within rtol 1e-5."""

import time

import numpy as np
import pytest
import torch

import pygraphblas_tpu as J
from pygraphblas_tpu.core import csr8 as jcsr8, dewise as jdw
from pygraphblas_tpu.core import sparse as jsp, spmspv as jspmspv
import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch import fused, generators, types
from pygraphblas_tpu_torch.core import csr8, dewise, sparse, spmspv
from pygraphblas_tpu_torch.core import xspmv as TX

import jax.numpy as jnp

SEMIRINGS = [("FP32", "PLUS_TIMES"), ("FP32", "MIN_PLUS"),
             ("FP32", "MAX_SECOND"), ("INT32", "PLUS_TIMES"),
             ("INT32", "MIN_FIRST"), ("INT64", "MAX_PLUS"),
             ("BOOL", "LOR_LAND"), ("INT32", "TIMES_PLUS"),
             ("FP32", "PLUS_PAIR")]


def _coo(rng, n, m, k, tname):
    cells = np.sort(rng.choice(n * m, k, replace=False))
    r, c = cells // m, cells % m
    if tname == "BOOL":
        v = rng.rand(k) > 0.3
    elif tname == "FP32":
        v = rng.uniform(-2, 2, k).astype(np.float32)
    else:
        v = rng.randint(-5, 6, k).astype(np.dtype(getattr(
            J.types, tname)._numpy_t))
    return r.astype(np.int64), c.astype(np.int64), v


def _x(rng, n, tname, frac=0.7):
    present = rng.rand(n) < frac
    if tname == "BOOL":
        vals = rng.rand(n) > 0.5
    elif tname == "FP32":
        vals = rng.uniform(-2, 2, n).astype(np.float32)
    else:
        vals = rng.randint(-3, 4, n).astype(np.dtype(getattr(
            J.types, tname)._numpy_t))
    return np.where(present, vals, np.zeros((), vals.dtype)), present


def _same(got, want, tname, fold=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if tname == "FP32" and fold:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.array_equal(got, want), (got, want)


@pytest.mark.parametrize("tname,sr", SEMIRINGS)
@pytest.mark.parametrize("flip", [False, True])
def test_csr8_masked_spmv_matches_jax(tname, sr, flip):
    rng = np.random.RandomState(len(sr) + flip)
    n, m = 40, 30
    r, c, v = _coo(rng, n, m, 300, tname)
    xv, xm = _x(rng, m, tname)
    jsem = getattr(getattr(J.types, tname), sr)
    tsem = getattr(getattr(T.types, tname), sr)
    zt = np.dtype(jsem.ztype._numpy_t)
    jplan = jcsr8.Csr8Plan(r, c, v, n, m)
    want = jcsr8.run_spmv_masked(jplan, jnp.asarray(xv), jnp.asarray(xm),
                                 jsem, zt, flip_mul=flip)
    tplan = csr8.Csr8Plan(r, c, v, n, m, "cpu")
    typ = getattr(T.types, tname)
    got = csr8.run_spmv_masked(tplan, typ.to_torch(xv), torch.as_tensor(xm),
                               tsem, zt, flip_mul=flip)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _same(tsem.ztype.to_numpy(got[0]), np.asarray(want[0]), tname)
    assert np.array_equal(tplan.row_present.numpy(),
                          np.asarray(jplan.row_present))


@pytest.mark.parametrize("tname,sr", SEMIRINGS[:5])
def test_csr8_dense_spmv_matches_jax(tname, sr):
    rng = np.random.RandomState(7)
    n = 50
    r, c, v = _coo(rng, n, n, 400, tname)
    xv, _ = _x(rng, n, tname, frac=1.0)
    jsem = getattr(getattr(J.types, tname), sr)
    tsem = getattr(getattr(T.types, tname), sr)
    zt = np.dtype(jsem.ztype._numpy_t)
    want = jcsr8.spmv_dense_x(jcsr8.Csr8Plan(r, c, v, n, n),
                              jnp.asarray(xv), jsem, zt)
    typ = getattr(T.types, tname)
    got = csr8.spmv_dense_x(csr8.Csr8Plan(r, c, v, n, n, "cpu"),
                            typ.to_torch(xv), tsem, zt)
    _same(tsem.ztype.to_numpy(got[0]), np.asarray(want[0]), tname)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("tname,sr", SEMIRINGS + [("INT64",
                                                   "ANY_SECONDI")])
@pytest.mark.parametrize("flip", [False, True])
def test_coo_spmv_matches_jax(tname, sr, flip):
    rng = np.random.RandomState(3 + flip)
    n, m = 30, 25
    r, c, v = _coo(rng, n, m, 200, tname)
    xv, xm = _x(rng, m, tname)
    jsem = getattr(getattr(J.types, tname), sr)
    tsem = getattr(getattr(T.types, tname), sr)
    zt = np.dtype(jsem.ztype._numpy_t)
    want = jsp.coo_spmv(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                        jnp.asarray(xv), jnp.asarray(xm), jsem, zt.str, n,
                        flip_mul=flip)
    typ = getattr(T.types, tname)
    got = sparse.coo_spmv(torch.as_tensor(r), torch.as_tensor(c),
                          typ.to_torch(v), typ.to_torch(xv),
                          torch.as_tensor(xm), tsem, zt, n, flip_mul=flip)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    if sr == "ANY_SECONDI":     # any of the row's candidates
        return
    _same(tsem.ztype.to_numpy(got[0]), np.asarray(want[0]), tname)


@pytest.mark.parametrize("tname,mon", [("FP32", "PLUS"), ("INT32", "MIN"),
                                       ("INT64", "TIMES"), ("BOOL", "LOR"),
                                       ("BOOL", "LXOR"), ("UINT32", "MAX"),
                                       ("UINT16", "BOR")])
def test_segment_reduce_matches_jax(tname, mon):
    rng = np.random.RandomState(11)
    ids = np.sort(rng.randint(0, 20, 120))
    if tname == "BOOL":
        vals = rng.rand(120) > 0.5
    elif tname == "FP32":
        vals = rng.uniform(-2, 2, 120).astype(np.float32)
    else:
        vals = rng.randint(0, 7, 120).astype(
            np.dtype(getattr(J.types, tname)._numpy_t))
    jm = getattr(getattr(J.types, tname), mon + "_MONOID")
    tm = getattr(getattr(T.types, tname), mon + "_MONOID")
    typ = getattr(T.types, tname)
    dt = np.dtype(typ._numpy_t)
    got = sparse.coo_segment_reduce(torch.as_tensor(ids), typ.to_torch(vals),
                                    tm, dt, 25)
    if mon != "BOR":   # the JAX segment reduce has no bitwise fold
        want = jsp.coo_segment_reduce(jnp.asarray(ids), jnp.asarray(vals),
                                      jm, dt.str, 25)
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        _same(typ.to_numpy(got[0]), np.asarray(want[0]), tname)
    else:              # the generic fold, against numpy
        want = np.zeros(25, dt)
        for i, x in zip(ids, vals):
            want[i] |= x
        assert np.array_equal(typ.to_numpy(got[0]), want)
    uids, red = sparse.coo_segment_reduce_compact(ids * 1000, vals, tm, dt,
                                                  "cpu")
    if mon != "BOR":
        wu, wr = jsp.coo_segment_reduce_compact(ids * 1000, vals, jm, dt)
        assert np.array_equal(uids, wu)
        _same(red, wr, tname)


@pytest.mark.parametrize("tname,sr", SEMIRINGS[:7] + [
    ("INT64", "ANY_SECONDI"), ("FP32", "MIN_RMINUS"), ("INT32", "PLUS_ISEQ")])
@pytest.mark.parametrize("flip", [False, True])
def test_spmspv_matches_jax(tname, sr, flip):
    rng = np.random.RandomState(5 + flip)
    n = 40
    r, c, v = _coo(rng, n, n, 250, tname)
    u, s, d = np.unique(r, return_index=True, return_counts=True)
    fi = np.sort(rng.choice(n, 6, replace=False))
    fx, _ = _x(rng, 6, tname, frac=1.0)
    jsem = getattr(getattr(J.types, tname), sr)
    tsem = getattr(getattr(T.types, tname), sr)
    zt = np.dtype(jsem.ztype._numpy_t)
    wu, wv = jspmspv.spmspv(u, s, d, c, v, fi, fx, jsem, zt, flip_mul=flip)
    gu, gv = spmspv.spmspv(u, s, d, c, v, fi, fx, tsem, zt, flip_mul=flip,
                           device="cpu")
    assert np.array_equal(gu, wu)
    if sr != "ANY_SECONDI":
        _same(gv, wv, tname)
    s_ent, s_off = spmspv.expand_segments(s[:3], d[:3])
    w_ent, w_off = jspmspv.expand_segments(s[:3], d[:3])
    assert np.array_equal(s_ent, w_ent) and np.array_equal(s_off, w_off)


def test_spmspv_needs_a_device():
    """The caller names the device the multiply and the reduce run on."""
    u = s = d = np.zeros(1, np.int64)
    with pytest.raises(TypeError):
        spmspv.spmspv(u, s, d, u, u, u, u, T.types.INT64.PLUS_TIMES,
                      np.int64)


@pytest.mark.parametrize("union", [True, False])
@pytest.mark.parametrize("tname,op", [("FP32", "PLUS"), ("INT32", "MINUS"),
                                      ("INT64", "MAX"), ("FP32", "LT")])
def test_dewise_matches_jax(union, tname, op):
    rng = np.random.RandomState(17)
    ra, ca, va = _coo(rng, 60, 60, 300, tname)
    rb, cb, vb = _coo(rng, 60, 60, 250, tname)
    jop = getattr(getattr(J.types, tname), op)
    top = getattr(getattr(T.types, tname), op)
    cdt = np.dtype(getattr(T.types, tname)._numpy_t)
    odt = np.dtype(np.bool_) if op == "LT" else cdt
    want = jdw.ewise(ra, ca, va, rb, cb, vb, jop.apply, (jop, cdt.str),
                     cdt, odt, union=union)
    got = dewise.ewise(ra, ca, va, rb, cb, vb, top.apply, cdt, odt,
                       union=union, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    sel_j = jdw.select(ra, ca, va, J.selectop.TRIL.apply, "tril",
                       np.int64(-2))
    sel_t = dewise.select(ra, ca, va, T.selectop.TRIL.apply, np.int64(-2),
                          device="cpu")
    for g, w in zip(sel_t, sel_j):
        assert np.array_equal(g, np.asarray(w))
    assert dewise.eligible(10, 10, 5, 5, cdt, odt) == \
        jdw.eligible(10, 10, 5, 5, cdt, odt)


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


def test_eager_mxv_async_upgrade(async_mode):
    rows, cols, n = generators.rmat_edges(12, 16, seed=4)
    T.options_set(bitmap_max_cells=1 << 20)
    A = generators.to_matrix(rows, cols, n, types.FP32, device="cpu")
    x = T.Vector.dense(types.FP32, n, fill=1.5, device="cpu")
    y1 = A.mxv(x, semiring=types.FP32.PLUS_TIMES)      # csr8 meanwhile
    key = ("x", False, np.dtype(np.float32).str)
    assert _wait_plan(A, key), "background plan build never landed"
    y2 = A.mxv(x, semiring=types.FP32.PLUS_TIMES)      # xspmv
    np.testing.assert_allclose(y1._vals.numpy(), y2._vals.numpy(),
                               rtol=1e-4, atol=1e-8)


def test_async_plan_stale_write_discarded(async_mode):
    rows, cols, n = generators.rmat_edges(12, 16, seed=5)
    A = generators.to_matrix(rows, cols, n, types.FP32, device="cpu")
    fused.pagerank(A, itermax=2, tol=0.0, device="cpu")  # starts the build
    A[0, 1] = 2.0                                  # resets the caches
    A.wait()
    time.sleep(1.0)
    assert ("x", True, np.dtype(np.float32).str) not in (A._ell_c or {})
    r = fused.pagerank(A, itermax=5, tol=0.0, device="cpu")
    assert torch.isfinite(r._vals).all()
