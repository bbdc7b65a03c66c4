"""Port parity for slice 2's entry points: fused BFS, batched BFS, SSSP
and BC over the xspmv engine, against the JAX package's ``fused`` on the
same graphs.

Both packages build their own plans.  The port's permutations take its
native route (fill 128):
  - kron-12 ef16, A^T: D=2, S=5, K=106, so _mid_pass, then the fold8
    after the permutation, then 3 fold levels (BFS, SSSP);
  - kron-12 symmetrised: D=2, S=7, K=128, so _mid_pass, then the fold8
    fused into the last ascend (BC).
The JAX package here has no native routing and takes its greedy route
(fill 112), so the two permutations differ while their results must
not: levels and distances equal exactly, BC within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from pygraphblas_tpu import fused as jfused, generators as jgen
from pygraphblas_tpu import types as jtypes
from pygraphblas_tpu_torch import fused, generators, types
from pygraphblas_tpu_torch.core import xspmv as TX


@pytest.fixture(scope="module")
def kron12():
    rows, cols, n = generators.rmat_edges(12, 16)
    assert len(rows) >= TX.MIN_NNZ
    return rows, cols, n


@pytest.fixture(scope="module")
def kron12_sym(kron12):
    rows, cols, n = kron12
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


def _perm_shape(A, transpose):
    p = A._xspmv_plan(transpose, np.float32, device="cpu")
    return (p.perm.D, p.perm.S, p.perm.K, len(p.levels))


def test_bfs_level_and_batch_match_jax(kron12):
    rows, cols, n = kron12
    A = generators.to_matrix(rows, cols, n, types.BOOL)
    assert _perm_shape(A, True) == (2, 5, 106, 3)
    jA = jgen.to_matrix(rows, cols, n, jtypes.BOOL)
    lv = fused.bfs_level(A, 0, device="cpu")
    assert lv.type is types.INT64 and lv._vals.dtype == torch.int64
    jv, jm = (np.asarray(a) for a in jfused.bfs_level(jA, 0)._host_pair())
    v, m = lv._host_pair()
    assert np.array_equal(m, jm)
    assert np.array_equal(v[m], jv[jm])
    assert v.max() > 2                       # the loop ran several levels

    srcs = [0, 1, 7]
    got = fused.bfs_batch(A, srcs, device="cpu")
    want = np.asarray(jfused.bfs_batch(jA, srcs))
    assert got.dtype == torch.int32 and got.shape == (3, n)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got[0].numpy(), lv.to_numpy())


def test_sssp_matches_jax(kron12):
    rows, cols, n = kron12
    # GAP's integer weights 1..255: every path sum is exact in float32
    w = np.random.RandomState(1).randint(1, 256, len(rows)).astype(
        np.float32)
    A = generators.to_matrix(rows, cols, n, types.FP32, vals=w)
    d = fused.sssp(A, 0, device="cpu")
    jd = jfused.sssp(jgen.to_matrix(rows, cols, n, jtypes.FP32, vals=w), 0)
    jv, jm = (np.asarray(a) for a in jd._host_pair())
    v, m = d._host_pair()
    assert np.array_equal(m, jm) and m.sum() > 1
    assert np.array_equal(v[m], jv[jm])
    assert np.isinf(v[~m]).all()


def test_bc_matches_jax(kron12_sym):
    rows, cols, n = kron12_sym
    A = generators.to_matrix(rows, cols, n, types.FP32)
    assert _perm_shape(A, True)[:3] == (2, 7, 128)
    srcs = [0, 3]          # two sources: the JAX loop compiles per source
    got = fused.bc(A, srcs, device="cpu").to_numpy()
    jA = jgen.to_matrix(rows, cols, n, jtypes.FP32)
    # A is symmetric, so the plans of A^T w and A w are the same plan:
    # build the JAX one once (its greedy route takes seconds here)
    jA._ell_c[("x", False, np.dtype(np.float32).str)] = jA._xspmv_plan(
        True, np.float32)
    want = np.asarray(jfused.bc(jA, srcs).to_numpy())
    # fp32 sums in another order (XLA on the CPU vs torch)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(want).max() > 0


def test_unported_fallbacks_raise(kron12):
    """Where the JAX package falls back to csr8 or the eager algorithms,
    the port now takes the same route (it raised NotImplementedError
    before): small graphs and integer SSSP give the JAX package's
    answers."""
    rows, cols, n = generators.rmat_edges(8, 4)
    small = generators.to_matrix(rows, cols, n, types.BOOL)
    jsmall = jgen.to_matrix(rows, cols, n, jtypes.BOOL)
    assert small.nvals < TX.MIN_NNZ
    assert fused.bfs_level(small, 0, device="cpu").to_lists() == \
        jfused.bfs_level(jsmall, 0).to_lists()
    assert np.array_equal(fused.bfs_batch(small, [0], device="cpu").numpy(),
                          np.asarray(jfused.bfs_batch(jsmall, [0])))
    fsmall = generators.to_matrix(rows, cols, n, types.FP32)
    jfsmall = jgen.to_matrix(rows, cols, n, jtypes.FP32)
    assert fused.sssp(fsmall, 0, device="cpu").to_lists() == \
        jfused.sssp(jfsmall, 0).to_lists()
    np.testing.assert_allclose(
        fused.bc(fsmall, [0], device="cpu").to_numpy(),
        np.asarray(jfused.bc(jfsmall, [0]).to_numpy()), rtol=1e-5,
        atol=1e-5)
    rows, cols, n = kron12
    ints = generators.to_matrix(rows, cols, n, types.INT32)
    floats = jgen.to_matrix(rows, cols, n, jtypes.FP32)
    got = fused.sssp(ints, 0, device="cpu")
    assert got.type is types.INT32
    i, v = got.to_lists()
    wi, wv = jfused.sssp(floats, 0).to_lists()
    assert i == wi and v == [int(x) for x in wv]
