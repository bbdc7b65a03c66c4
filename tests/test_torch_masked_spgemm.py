"""The port's masked SpGEMM and triangle count against the JAX package
on the CPU: the slowest cases of tests/test_torch_algorithms.py, in a
file of their own so that the suite's workers run them beside its
longest file.

masked_spgemm runs three ways: as the port runs on the CPU (the generic
intersect as torch ops), with the fused-path predicate made true so that
the plain versions of kernels 10 and 11 run through the full dispatch
(the pair path both fused and as the unfused chain of kernel 9), and
with WIDTH_CAP lowered in both packages so that the heavy host path
runs.  Rows and columns must be exact; values exact, or within rtol 1e-5
for float32 PLUS (another fold order).  ``triangle_count`` equals the
JAX package's and scipy's.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from pygraphblas_tpu import algorithms as jalg, generators as jgen
from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu.core import spgemm as jsg
from pygraphblas_tpu_torch import algorithms, generators, types
from pygraphblas_tpu_torch.core import spgemm


def _sym(scale):
    rows, cols, n = generators.rmat_edges(scale, 16)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


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
