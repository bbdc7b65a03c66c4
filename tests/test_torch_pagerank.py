"""Port parity for the slice as a whole: fused PageRank over xspmv, the
generators, the entry points' device rules, and the import boundary
(the port never imports JAX or the JAX package)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pygraphblas_tpu import fused as jfused, generators as jgen
from pygraphblas_tpu_torch import fused, generators, options_set, types
from pygraphblas_tpu_torch.core import xspmv as TX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_port_never_imports_jax():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pygraphblas_tpu"), \
                (path, mod)
    # and at run time, in a fresh interpreter
    code = ("import sys, pygraphblas_tpu_torch.fused, "
            "pygraphblas_tpu_torch.convert, pygraphblas_tpu_torch._kernels, "
            "pygraphblas_tpu_torch.algorithms, "
            "pygraphblas_tpu_torch.core.spgemm, "
            "pygraphblas_tpu_torch.core.gustavson, "
            "pygraphblas_tpu_torch.core.esc, pygraphblas_tpu_torch.core.scan, "
            "pygraphblas_tpu_torch.core.dense, "
            "pygraphblas_tpu_torch.core.coosem, "
            "pygraphblas_tpu_torch.core.coosparse, "
            "pygraphblas_tpu_torch.core.sparse, "
            "pygraphblas_tpu_torch.core.csr8, "
            "pygraphblas_tpu_torch.core.spmspv, "
            "pygraphblas_tpu_torch.core.dewise, "
            "pygraphblas_tpu_torch.matrix, pygraphblas_tpu_torch.vector, "
            "pygraphblas_tpu_torch.generators, "
            "pygraphblas_tpu_torch.testing, pygraphblas_tpu_torch.ops.table, "
            "pygraphblas_tpu_torch.types, pygraphblas_tpu_torch.binaryop, "
            "pygraphblas_tpu_torch.unaryop, pygraphblas_tpu_torch.monoid, "
            "pygraphblas_tpu_torch.semiring, pygraphblas_tpu_torch.selectop, "
            "pygraphblas_tpu_torch.descriptor, pygraphblas_tpu_torch.scalar, "
            "pygraphblas_tpu_torch.base, pygraphblas_tpu_torch.gviz, "
            "pygraphblas_tpu_torch.io.mm, pygraphblas_tpu_torch.io.binfile, "
            "pygraphblas_tpu_torch.io.native;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'pygraphblas_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


# the modules slices 11 and 12 add to or change, and the calls that reach
# their new code
SLICE_MODULES = ["__init__.py", "algorithms.py", "base.py", "matrix.py",
                 "selectop.py", "vector.py", "core/coosem.py",
                 "core/dense.py", "fused.py", "gviz.py", "testing.py",
                 "_native.py", "io/__init__.py", "io/binfile.py", "io/mm.py",
                 "io/native.py"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_never_imports_jax(module):
    """No import of jax or the JAX package anywhere in the module, at its
    top or inside a function."""
    path = os.path.join(ROOT, "pygraphblas_tpu_torch", module)
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib",
                                         "pygraphblas_tpu"), (path, mod)


def test_slice_calls_never_import_jax(tmp_path):
    """Louvain, extract/assign over ranges, Kronecker, the diagonals,
    the printers, the unsigned selects and the profiler (slice 11), and
    the frontier BFS, the DNN, the I/O and gviz (slice 12), run in a
    fresh interpreter on the CPU, load neither jax nor the JAX
    package."""
    code = f"""
import sys
import numpy as np
import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch import algorithms, base
A = T.Matrix.from_lists([0, 1, 2, 2], [1, 2, 0, 1], [1.0, 2.0, 3.0, 4.0],
                        device="cpu")
base.profile_start({str(tmp_path)!r})
A[0:1, :]; A[1:2, 0:1] = A[0:1, 1:2]; A.kronecker(A).kronpow(1)
A.assign_col(2, A[:, 0]); A.vector_diag(1); A.resize(4, 4); A.gini()
T.Matrix.from_diag(A.vector_diag()); str(A); A.to_html_table()
U = T.Matrix.from_lists([0], [0], [3000000000], typ=T.UINT32, device="cpu")
assert (U > 0).nvals == 1
base.profile_stop()
algorithms.louvain_cluster(A.eadd(A.T), device="cpu")
from pygraphblas_tpu_torch import fused, gviz, testing
B = T.Matrix.from_lists(list(range(99)), list(range(1, 100)), [True] * 99,
                        nrows=100, ncols=100, device="cpu")
fused.bfs_frontier(B, 0, device="cpu"); algorithms.bfs_level(B, 0)
algorithms.bfs_parents(B, 0)
n, W = testing.radix_net([4, 4], 2, weight=0.5, device="cpu")
Bs = testing.build_biases(n, 2, -0.25, device="cpu")
Y = T.Matrix.from_lists([0, 1], [3, 5], [1.0, 1.0], nrows=2, ncols=n,
                        device="cpu")
fused.dnn(W, Bs, Y, device="cpu"); algorithms.dnn(W, Bs, Y)
algorithms.hyperdnn(2, algorithms.hypergraph(W),
                    algorithms.hypergraph(Bs, diag=True),
                    T.Matrix.from_lists([0], [3], [1.0], nrows=1,
                                        ncols=3 * n, device="cpu"))
p = {str(tmp_path)!r} + "/m.mtx"
with open(p, "w") as f:
    A.to_mm(f)
T.Matrix.from_mm(p, device="cpu"); A.binwrite(p + ".grb")
T.Matrix.binread(p + ".grb", device="cpu"); gviz.draw_cy(A)
U64 = T.Matrix.from_lists([0], [0], [2**63 + 2048], typ=T.UINT64, device="cpu")
assert U64.select(lambda i, j, x, t: x > t, 1).nvals == 1
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygraphblas_tpu')]
print(bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


def test_version_and_init_match_jax():
    import pygraphblas_tpu as J
    import pygraphblas_tpu_torch as T

    assert T.get_version() == J.get_version() == T.__version__
    assert T.init() is None and T.init(blocking=True) is None
    for name in ("IMPLEMENTATION_MAJOR", "IMPLEMENTATION_MINOR",
                 "IMPLEMENTATION_SUB", "IMPLEMENTATION_VERSION"):
        assert getattr(T, name) == getattr(J, name)


def test_profile_writes_a_trace(tmp_path):
    """profile_start / profile_stop (torch.profiler) write a trace of the
    work between them into the directory."""
    from pygraphblas_tpu_torch import base

    base.profile_start(str(tmp_path))
    A = generators.to_matrix(*generators.rmat_edges(5, 4), device="cpu")
    A.mxm(A)
    base.profile_stop()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1
    assert os.path.getsize(os.path.join(tmp_path, traces[0])) > 0


def test_host_allocator_tuned_at_import():
    """The allocator tuning runs at import unless PYGB_MALLOC_TUNE=0 (a
    fresh interpreter each, torch loaded first, then mallopt observed
    through a stand-in libc)."""
    code = ("import ctypes, sys, torch\n"
            "calls = []\n"
            "class L:\n"
            "    def mallopt(self, *a): calls.append(a)\n"
            "ctypes.CDLL = lambda *a, **k: L()\n"
            "import pygraphblas_tpu_torch\n"
            "print(calls)\n")
    for env, want in (("1", "[(-4, 0), (-1, 2147483647)]"), ("0", "[]")):
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True,
                             env={**os.environ, "PYGB_MALLOC_TUNE": env})
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip().splitlines()[-1] == want
