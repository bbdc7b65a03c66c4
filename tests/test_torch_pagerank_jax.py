"""The port's fused PageRank against the JAX package's and against the
planless COO oracle on the CPU at kron-12 (the xspmv engine's plain
versions): the slowest cases of tests/test_torch_pagerank.py, in a file
of their own so that the suite's workers run them beside its longest
file."""

import numpy as np
import pytest

from pygraphblas_tpu import fused as jfused, generators as jgen
from pygraphblas_tpu_torch import fused, generators, types
from pygraphblas_tpu_torch.core import xspmv as TX


@pytest.fixture(scope="module")
def kron12():
    rows, cols, n = generators.rmat_edges(12, 16)
    return rows, cols, n


@pytest.mark.parametrize("itermax,tol", [(100, 1e-4), (30, -1.0)])
def test_pagerank_matches_jax(kron12, itermax, tol):
    rows, cols, n = kron12
    A = generators.to_matrix(rows, cols, n, types.FP32)
    assert A.nvals >= TX.MIN_NNZ            # the xspmv engine applies
    got = fused.pagerank(A, itermax=itermax, tol=tol,
                         device="cpu").to_numpy()
    jA = jgen.to_matrix(rows, cols, n)
    want = np.asarray(jfused.pagerank(jA, itermax=itermax,
                                      tol=tol).to_numpy())
    # fp32 reduction order differs between XLA on the CPU and torch
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pagerank_matches_coo_oracle(kron12):
    rows, cols, n = kron12
    A = generators.to_matrix(rows, cols, n, types.FP32)
    r5 = fused.pagerank(A, itermax=5, tol=0.0, device="cpu")
    rows_d, cols_d, _ = A._device_coo("cpu")
    d_inv = fused._d_inv(fused._deg_vec(A, "cpu"), 0.85)
    ref, _, iters = fused._pagerank_loop_coo(
        rows_d, cols_d, n, 5, d_inv, np.float32(0.15 / n), 0.0)
    assert iters == 5
    err = (r5._vals - ref).abs().max()
    assert err <= 1e-5 * ref.abs().max()
