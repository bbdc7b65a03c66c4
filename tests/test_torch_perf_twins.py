"""The port's twins of the JAX package's perf scripts
(``perf/torch_urand_e2e.py``, ``torch_road_bfs.py``,
``torch_dewise_bench.py``, ``torch_louvain_scale.py``) against the JAX
package, on the CPU at small sizes: each twin's graph builder equal to
its JAX script's (the scripts loaded by path), and each twin's result
equal to the JAX function it stands for on the same graph."""

import ast
import importlib.util
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import pygraphblas_tpu as J
from pygraphblas_tpu import fused as jfused, types as jtypes
from pygraphblas_tpu.algorithms import louvain_cluster as jlouvain
from pygraphblas_tpu.core import dewise as jdewise
from pygraphblas_tpu.generators import to_matrix as jto_matrix
from pygraphblas_tpu.generators import urand_edges as jurand

PERF = Path(__file__).resolve().parent.parent / "perf"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_perf_{name}", PERF / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dewise_make(nnz, n):
    """perf/dewise_bench.py's ``make``, which main() defines inside
    itself: its source, run with main's ``n`` and ``args.nnz``."""
    src = (PERF / "dewise_bench.py").read_text()
    main = next(f for f in ast.parse(src).body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    make = next(f for f in ast.walk(main)
                if isinstance(f, ast.FunctionDef) and f.name == "make")
    ns = dict(np=np, n=n, args=SimpleNamespace(nnz=nnz))
    exec(textwrap.dedent(ast.get_source_segment(src, make)), ns)
    return ns["make"]


def _args(mod, argv):
    return mod.parser().parse_args(argv + ["--device", "cpu"])


def test_graph_builders_equal_the_jax_scripts():
    """road_graph, planted_block_graph and dewise's make are the JAX
    scripts' own; urand_edges is the JAX package's."""
    from pygraphblas_tpu_torch.generators import urand_edges

    road, lv, dw = (_load(f"torch_{m}") for m in ("road_bfs",
                                                  "louvain_scale",
                                                  "dewise_bench"))
    for got, want in ((road.road_graph(48), _load("road_bfs").road_graph(48)),
                      (lv.planted_block_graph(8, 40),
                       _load("louvain_scale").planted_block_graph(8, 40)),
                      (dw.make(5000, 2, 1 << 16),
                       _jax_dewise_make(5000, 1 << 16)(2)),
                      (urand_edges(10, 8, seed=3), jurand(10, 8, seed=3))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))


def test_road_twin_levels_equal_jax_bfs_frontier():
    """Side 64: the twin's levels from 0 and 1 (its scipy gate passes)
    equal the JAX package's fused.bfs_frontier on the same graph."""
    from pygraphblas_tpu_torch import Matrix, fused, types

    road = _load("torch_road_bfs")
    res = road.run(_args(road, ["--side", "64"]))
    rows, cols, n = road.road_graph(64)
    A = J.Matrix.sparse(jtypes.BOOL, n, n)
    A._build(rows, cols, np.ones(len(rows), np.bool_))
    B = Matrix.sparse(types.BOOL, n, n, device="cpu")
    B._build(rows, cols, np.ones(len(rows), np.bool_))
    for tag, src in (("device_first", 0), ("device_warm", 1)):
        want = [np.asarray(x) for x in jfused.bfs_frontier(A, src)
                .to_arrays()]
        got = fused.bfs_frontier(B, src, device="cpu").to_arrays()
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert res[tag]["reached"] == len(want[0])
        assert res[tag]["levels"] == int(want[1].max())
    assert res["host"]["reached"] == n


def test_dewise_twin_equals_jax_dewise():
    """20k + 20k entries: the port's device engine (its gate against the
    host engine passes) equals the JAX package's dewise.ewise."""
    dw = _load("torch_dewise_bench")
    assert dw.run(_args(dw, ["--nnz", "20000"]))["out_nnz"] > 20000
    from pygraphblas_tpu_torch.core import dewise

    ra, ca, va = dw.make(20000, 1)
    rb, cb, vb = dw.make(20000, 2)
    got = dewise.ewise(ra, ca, va, rb, cb, vb, lambda x, y: x + y,
                       np.float32, np.float32, union=True)
    want = jdewise.ewise(ra, ca, va, rb, cb, vb, lambda x, y: x + y,
                         ("plus",), np.float32, np.float32, union=True)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_dewise_twin_gate_fails_on_a_wrong_merge(monkeypatch):
    """A device result that differs from the host's exits 1."""
    dw = _load("torch_dewise_bench")
    from pygraphblas_tpu_torch.core import dewise

    orig = dewise.merge
    monkeypatch.setattr(dewise, "merge", lambda r, c, v, *a: orig(
        r, c, v * 2, *a))
    assert dw.main(["--nnz", "2000", "--device", "cpu"]) == 1


def test_urand_twin_tiers_equal_jax_pagerank(tmp_path, monkeypatch):
    """Scale 12: the first touch runs on the planless COO loop while the
    plan builds in its thread (a temporary cache directory), the warm
    run on the xspmv plan; both gates pass, and the ranks are within
    1e-5 of the JAX package's fused.pagerank on the same graph."""
    from pygraphblas_tpu_torch.core import xspmv

    monkeypatch.setattr(xspmv, "PLAN_CACHE_DIR", str(tmp_path))
    ur = _load("torch_urand_e2e")
    kept = {}
    res = ur.run(_args(ur, ["--scale", "12", "--iters", "20",
                            "--seed", "5"]), kept)
    assert (res["first_engine"], res["warm_engine"]) == ("coo", "xspmv")
    assert res["tier_max_diff"] < 1e-5
    rows, cols, n = jurand(12, 16, seed=5)
    want = np.asarray(jfused.pagerank(jto_matrix(rows, cols, n,
                                                 jtypes.FP32),
                                      itermax=20, tol=-1.0)._vals)
    got = kept["ranks"]._vals.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_louvain_twin_labels_equal_jax():
    """8 blocks of 40: the twin's labels equal the JAX package's
    louvain_cluster on the JAX script's graph; every block found."""
    lv = _load("torch_louvain_scale")
    from pygraphblas_tpu_torch import Matrix, algorithms, types

    src, dst, n = lv.planted_block_graph(8, 40)
    A = J.Matrix.sparse(jtypes.FP64, n, n)
    A._build(src.astype(np.int64), dst.astype(np.int64), np.ones(len(src)))
    want = np.asarray(jlouvain(A).npV)
    B = Matrix.sparse(types.FP64, n, n, device="cpu")
    B._build(src.astype(np.int64), dst.astype(np.int64), np.ones(len(src)))
    got = np.zeros(n, np.int64)
    i, v = algorithms.louvain_cluster(B, device="cpu")._coo()
    got[i] = v
    assert np.array_equal(got, want)
    res = lv.run(_args(lv, ["8", "40"]))
    assert res["communities"] == 8 and res["purity"] == 1.0


@pytest.mark.parametrize("script", ["urand_e2e", "road_bfs", "dewise_bench",
                                    "louvain_scale"])
def test_twin_keeps_the_jax_scripts_flags(script):
    """Each twin takes its JAX script's flags, and --device (the card by
    default)."""
    src = (PERF / f"{script}.py").read_text()
    flags = {a.value for a in ast.walk(ast.parse(src))
             if isinstance(a, ast.Constant) and isinstance(a.value, str)
             and a.value.startswith("--")}
    twin = _load(f"torch_{script}").parser()
    have = {o for a in twin._actions for o in a.option_strings}
    assert flags <= have and "--device" in have
    assert twin.parse_args([]).device == "cuda"
