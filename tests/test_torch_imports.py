"""The port's import rule in a fresh interpreter, the profiler hooks and
the allocator tuning at import: the slowest cases of
tests/test_torch_pagerank.py (each starts an interpreter), in a file of
their own so that the suite's workers run them beside its longest
file.  The port never imports jax or the JAX package, statically (every
module) and at run time (the calls of every slice)."""

import ast
import os
import subprocess
import sys

from pygraphblas_tpu_torch import generators


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


# the JAX package's measurement scripts, as modules (perf/*.py but the
# port's own perf/torch_*.py, bench.py, __graft_entry__.py)
_JAX_SCRIPTS = ("perf", "bench", "__graft_entry__") + tuple(
    f[:-3] for f in os.listdir(os.path.join(ROOT, "perf"))
    if f.endswith(".py") and not f.startswith("torch_"))


def _port_files():
    """The package, the gallery, the GAP drivers, the docs generator,
    chip_smoke.py and the port's perf scripts (perf/torch_*.py)."""
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "docs", "generate_torch.py")]
    out += [os.path.join(ROOT, "perf", f)
            for f in sorted(os.listdir(os.path.join(ROOT, "perf")))
            if f.startswith("torch_") and f.endswith(".py")]
    for top in ("pygraphblas_tpu_torch", "demo_torch", "gap_torch"):
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_port_never_imports_jax():
    files = _port_files()
    assert len(files) > 10
    for top in ("demo_torch", "gap_torch", "generate_torch",
                "torch_urand_e2e", "torch_road_bfs", "torch_dewise_bench",
                "torch_louvain_scale"):
        assert any(top in f for f in files), top
    assert {"urand_e2e", "road_bfs", "dewise_bench",
            "louvain_scale"} <= set(_JAX_SCRIPTS)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pygraphblas_tpu", "demo",
                               "gap") + _JAX_SCRIPTS, (path, mod)
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
            "pygraphblas_tpu_torch.io.native, demo_torch.graphs, "
            "demo_torch.dnn.challenge, gap_torch.prmark, gap_torch.bcmark;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'pygraphblas_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


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
