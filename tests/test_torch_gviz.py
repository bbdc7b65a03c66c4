"""The port's drawing helpers (``gviz``) against the JAX package's on the
CPU (graphviz sources equal as strings, PIL images equal byte for
byte), ``run_doctests`` over the port's modules, and the public names:
the port lacks none of the JAX package's, the distributed tier
(``parallel`` and ``Matrix.shard``) included, and none of its gallery
scripts and GAP drivers."""

import doctest
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest

import pygraphblas_tpu as J
import pygraphblas_tpu_torch as T

graphviz = pytest.importorskip("graphviz")


def _both():
    from pygraphblas_tpu import gviz as jg
    from pygraphblas_tpu_torch import gviz as tg

    out = []
    for pkg, g, kw in ((J, jg, {}), (T, tg, dict(device="cpu"))):
        M = pkg.Matrix.from_lists([0, 1, 2, 2], [1, 2, 0, 1],
                                  [1.5, 2.0, 3.0, 0.25], **kw)
        B = pkg.Matrix.from_lists([0, 1], [2, 0], [7, 9], **kw)
        v = pkg.Vector.from_lists([0, 2], [7, 9], **kw)
        out.append((g, M, B, v))
    return out


DRAWINGS = {
    "graph": lambda g, M, B, v: g.draw_graph(M),
    "graph_options": lambda g, M, B, v: g.draw_graph(
        M, name="x", rankdir="TB", show_weight=False, concentrate=False,
        label_vector=v, label_width=1, size_vector={0: 2, 1: 3},
        log_scale=True, weight_prefix="w=", directed=False, ioff=1,
        joff=2),
    "graph_cmaps": lambda g, M, B, v: g.draw_graph(
        M, edge_cmap="viridis", label_vector=[0.1, 0.5, 0.9],
        label_cmap="plasma"),
    "hypergraph": lambda g, M, B, v: g.draw_graph(M, B=B),
    "vector_dot": lambda g, M, B, v: g.draw_vector_dot(v),
    "dispatch": lambda g, M, B, v: (g.draw(M).source
                                    + g.draw(v, "n").source),
    "layers": lambda g, M, B, v: g.draw_layers([M, M], label_width=2),
    "graph_op": lambda g, M, B, v: g.draw_graph_op(M, "+", M, M),
}


@pytest.mark.parametrize("name", sorted(DRAWINGS))
def test_graphviz_sources_equal_jax(name):
    (jg, *ja), (tg, *ta) = _both()
    want, got = DRAWINGS[name](jg, *ja), DRAWINGS[name](tg, *ta)
    if not isinstance(want, str):
        want, got = want.source, got.source
    assert got == want and len(got) > 20


def test_images_and_exports_equal_jax():
    """draw_matrix, draw_vector and draw_matrix_layers as pixels, and
    draw_cy's dict."""
    pytest.importorskip("PIL")
    (jg, jM, _, _), (tg, tM, _, _) = _both()
    jv = J.Vector.from_list([1, 2, 3])
    tv = T.Vector.from_list([1, 2, 3], device="cpu")
    for want, got in ((jg.draw_matrix(jM, scale=3), tg.draw_matrix(tM,
                                                                   scale=3)),
                      (jg.draw_vector(jv, scale=4), tg.draw_vector(tv,
                                                                   scale=4)),
                      (jg.draw_matrix_layers([jM, jM], scale=2),
                       tg.draw_matrix_layers([tM, tM], scale=2))):
        assert got.size == want.size
        assert got.tobytes() == want.tobytes()
    assert tg.draw_cy(tM, "g") == jg.draw_cy(jM, "g")
    with pytest.raises(TypeError):
        tg.draw(np.zeros(3))


def test_run_doctests_passes(monkeypatch):
    """run_doctests on the CPU returns 0 failures, having tried the I/O
    constructors', gviz's and scalar's examples."""
    tried = {}
    orig = doctest.testmod

    def counting(mod, **kw):
        r = orig(mod, **kw)
        tried[mod.__name__] = r.attempted
        return r

    monkeypatch.setattr(doctest, "testmod", counting)
    assert T.run_doctests(device="cpu") == 0
    assert sum(tried.values()) > 0
    assert tried["pygraphblas_tpu_torch.gviz"] == 23
    assert tried["pygraphblas_tpu_torch.matrix"] >= 24
    assert tried["pygraphblas_tpu_torch.scalar"] > 0


def _public(pkg):
    """A package's public top-level names and submodules."""
    names = {n for n in dir(pkg) if not n.startswith("_")}
    return names | {m.name for m in pkgutil.iter_modules(pkg.__path__)
                    if not m.name.startswith("_")}


def test_port_lacks_no_public_name_or_entry_point():
    """Of the JAX package's public names (top level, submodules, and the
    names of Matrix, Vector, Scalar, algorithms, fused, gviz, io and the
    distributed tier's modules), the port lacks none; each script of
    the JAX gallery (demo/NN_*.py) and each GAP driver (gap/*.py) has
    its counterpart of the same name in demo_torch/ and gap_torch/; and
    each JAX perf script whose workload the port runs has its
    perf/torch_ twin."""
    root = Path(__file__).resolve().parent.parent
    for jax_dir, glob in (("demo", "[0-9]*.py"), ("gap", "*.py")):
        want = {p.name for p in (root / jax_dir).glob(glob)}
        have = {p.name for p in (root / f"{jax_dir}_torch").glob(glob)}
        assert want and want <= have, (jax_dir, want - have)
    for script in ("urand_e2e", "road_bfs", "dewise_bench", "louvain_scale"):
        assert (root / "perf" / f"{script}.py").exists()
        assert (root / "perf" / f"torch_{script}.py").exists(), script
    assert _public(J) - _public(T) == set()
    for mod in ("gviz", "io", "io.mm", "io.binfile", "io.native",
                "parallel", "parallel.dist", "parallel.checkpoint"):
        importlib.import_module(f"pygraphblas_tpu_torch.{mod}")
    missing = {}
    for name in ("Matrix", "Vector", "Scalar"):
        gone = {n for n in dir(getattr(J, name)) if not n.startswith("_")} \
            - set(dir(getattr(T, name)))
        if gone:
            missing[name] = gone
    assert missing == {}
    for mod in ("algorithms", "fused", "gviz", "io.mm", "io.binfile",
                "parallel", "parallel.dist", "parallel.checkpoint"):
        jm = importlib.import_module(f"pygraphblas_tpu.{mod}")
        tm = importlib.import_module(f"pygraphblas_tpu_torch.{mod}")
        want = set(getattr(jm, "__all__", [n for n in dir(jm)
                                            if not n.startswith("_")
                                            and callable(getattr(jm, n))]))
        # JAX's own names, imported into the modules
        want -= {"jax", "jnp", "partial", "Mesh", "P", "NamedSharding"}
        assert want <= set(dir(tm)), (mod, want - set(dir(tm)))
