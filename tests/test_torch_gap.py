"""The port's GAP drivers (gap_torch/prmark.py, gap_torch/bcmark.py)
on the CPU against the JAX package's fused loops on the same kron-10
graph: ``prmark.run`` (fused, eager, each SpMV engine, the async plan,
a binfile) within 1e-5 of the largest rank of ``fused.pagerank``, and
``bcmark.run`` (fused, eager) within 1e-4 of ``fused.bc`` from the last
round's sources."""

import numpy as np
import pytest

from gap_torch import bcmark, prmark
from pygraphblas_tpu import fused as jfused, types as jtypes
from pygraphblas_tpu.generators import rmat_edges, to_matrix
from pygraphblas_tpu_torch.base import config


@pytest.fixture(scope="module")
def kron10():
    rows, cols, n = rmat_edges(10, 16)
    return to_matrix(rows, cols, n, jtypes.FP32), n


PR_CASES = {"fused": [], "eager": ["--eager"],
            "csr8": ["--engine", "csr8"], "xspmv": ["--engine", "xspmv"],
            "async_plan": ["--async-plan"]}


@pytest.mark.parametrize("case", sorted(PR_CASES))
def test_prmark_matches_jax(kron10, case):
    A, _ = kron10
    want = np.asarray(jfused.pagerank(A, damping=0.85, itermax=100,
                                      tol=1e-4).to_numpy())
    before = (config.spmv_engine, config.spmv_plan_async)
    stats = {}
    got = prmark.run(prmark.parser().parse_args(
        ["--scale", "10", "--rounds", "2", "--device", "cpu"]
        + PR_CASES[case]), stats).to_numpy()
    assert (config.spmv_engine, config.spmv_plan_async) == before
    assert len(stats["rounds_s"]) == 2 and min(stats["rounds_s"]) > 0
    assert stats["nnz"] == A.nvals
    assert np.abs(got - want).max() <= 1e-5 * want.max()


def test_prmark_binfile(kron10, tmp_path):
    """--binfile reads the JAX package's checkpoint of the graph."""
    A, _ = kron10
    path = str(tmp_path / "kron10.binfile")
    A.binwrite(path)
    want = np.asarray(jfused.pagerank(A, damping=0.85, itermax=100,
                                      tol=1e-4).to_numpy())
    got = prmark.run(prmark.parser().parse_args(
        ["--binfile", path, "--rounds", "1", "--device", "cpu"])).to_numpy()
    assert np.abs(got - want).max() <= 1e-5 * want.max()


@pytest.mark.parametrize("eager", [False, True], ids=["fused", "eager"])
def test_bcmark_matches_jax(kron10, eager):
    A, n = kron10
    batch = bcmark.sources(n, 2, 4)[-1]
    want = np.asarray(jfused.bc(A, batch).to_numpy())
    got = bcmark.run(bcmark.parser().parse_args(
        ["--rounds", "2", "--device", "cpu"]
        + (["--eager"] if eager else []))).to_numpy()
    assert want.max() > 0
    assert np.abs(got - want).max() <= 1e-4 * want.max()
