"""Port parity for the slice as a whole: the generators, the entry
points' device rules, and the import boundary, statically a module at a
time (the port never imports JAX or the JAX package).  Fused PageRank
against the JAX package is in tests/test_torch_pagerank_jax.py; the
import rule at run time, the profiler and the allocator tuning in
tests/test_torch_imports.py."""

import ast
import os

import numpy as np
import pytest
import torch

from pygraphblas_tpu import fused as jfused, generators as jgen
from pygraphblas_tpu_torch import fused, generators, options_set, types
from pygraphblas_tpu_torch.core import xspmv as TX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("gen", ["rmat_edges", "urand_edges"])
def test_generators_equal_jax(gen):
    a = getattr(generators, gen)(10, 8, seed=3)
    b = getattr(jgen, gen)(10, 8, seed=3)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_build_dedups_last_wins():
    A = generators.to_matrix(np.array([2, 0, 2]), np.array([1, 1, 1]), 3,
                             types.FP32, vals=np.array([1, 2, 3],
                                                       np.float32))
    r, c, v = A._coo()
    assert r.tolist() == [0, 2] and c.tolist() == [1, 1]
    assert v.tolist() == [2.0, 3.0]


def test_csr8_and_small_graphs_raise():
    """A graph below MIN_NNZ, and spmv_engine="csr8", take the csr8 loop
    (they raised NotImplementedError before) and match the JAX package,
    which takes the same route; "xspmv" still forces the plan."""
    rows, cols, n = generators.rmat_edges(8, 4)
    A = generators.to_matrix(rows, cols, n)
    jA = jgen.to_matrix(rows, cols, n)
    assert A.nvals < TX.MIN_NNZ

    def close(r, jr):
        got, want = r.to_numpy(), np.asarray(jr.to_numpy())
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    close(fused.pagerank(A, device="cpu"), jfused.pagerank(jA))
    assert not any(k[0] == "x" for k in A._cache())
    options_set(spmv_engine="xspmv")
    try:
        r = fused.pagerank(A, itermax=3, device="cpu")
        assert r.to_numpy().shape == (n,)
        assert any(k[0] == "x" for k in A._cache())
        options_set(spmv_engine="csr8")
        jfused.config.spmv_engine = "csr8"
        close(fused.pagerank(A, itermax=7, device="cpu"),
              jfused.pagerank(jA, itermax=7))
    finally:
        options_set(spmv_engine="auto")
        jfused.config.spmv_engine = "auto"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    A = generators.to_matrix(*generators.rmat_edges(6, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.pagerank(A)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    pkg = os.path.join(ROOT, "pygraphblas_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


# the modules slices 11 to 15 add to or change, and the calls that reach
# their new code
SLICE_MODULES = ["__init__.py", "algorithms.py", "base.py", "matrix.py",
                 "selectop.py", "vector.py", "core/coosem.py",
                 "core/dense.py", "fused.py", "gviz.py", "testing.py",
                 "_native.py", "io/__init__.py", "io/binfile.py", "io/mm.py",
                 "io/native.py", "parallel/__init__.py", "parallel/dist.py",
                 "parallel/checkpoint.py", "_opgen.py", "_unsigned.py"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_never_imports_jax(module):
    """No import of jax or the JAX package anywhere in the module, at its
    top or inside a function."""
    path = os.path.join(ROOT, "pygraphblas_tpu_torch", module)
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib",
                                         "pygraphblas_tpu"), (path, mod)


def test_version_and_init_match_jax():
    import pygraphblas_tpu as J
    import pygraphblas_tpu_torch as T

    assert T.get_version() == J.get_version() == T.__version__
    assert T.init() is None and T.init(blocking=True) is None
    for name in ("IMPLEMENTATION_MAJOR", "IMPLEMENTATION_MINOR",
                 "IMPLEMENTATION_SUB", "IMPLEMENTATION_VERSION"):
        assert getattr(T, name) == getattr(J, name)
