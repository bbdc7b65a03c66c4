"""The port's demo gallery checks against numpy/scipy oracles (the
machine with the card has no networkx); where networkx is installed,
each of those oracles agrees with networkx's, the JAX gallery's oracle,
on the demo's own graph."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
DEMOS = sorted((ROOT / "demo_torch").glob("[0-9]*.py"))


def _load(stem):
    path = next(p for p in DEMOS if p.name.startswith(stem))
    spec = importlib.util.spec_from_file_location(
        "demo_torch_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nx_graph(rows, cols, n, directed=False):
    nx = pytest.importorskip("networkx")
    G = nx.DiGraph() if directed else nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(zip(rows.tolist(), cols.tolist()))
    return nx, G


def _pagerank():
    from demo_torch import graphs

    rows, cols, n = _load("02").graph()
    nx, G = _nx_graph(rows, cols, n, directed=True)
    want = nx.pagerank(G, alpha=0.85, tol=1e-12, weight=None)
    got = graphs.pagerank(rows, cols, n, alpha=0.85)
    assert np.abs(got - [want[i] for i in range(n)]).max() < 1e-9


def _triangle_total(stem):
    from demo_torch import graphs

    rows, cols, n = _load(stem).graph()
    nx, G = _nx_graph(rows, cols, n)
    t = nx.triangles(G)
    want = np.array([t[i] for i in range(n)])
    assert want.sum() > 0
    assert np.array_equal(graphs.triangles(rows, cols, n), want)


def _k_truss():
    from demo_torch import graphs

    demo = _load("04")
    rows, cols, n = demo.graph()
    nx, G = _nx_graph(rows, cols, n)
    for k in demo.KS:
        assert graphs.k_truss_edges(rows, cols, n, k) == \
            2 * nx.k_truss(G, k).number_of_edges()


def _sssp():
    demo = _load("08")
    rows, cols, n, wts = demo.graph()
    nx, G = _nx_graph(rows, cols, n)
    for r, c, w in zip(rows.tolist(), cols.tolist(), wts.tolist()):
        G[r][c]["weight"] = w
    want = nx.single_source_dijkstra_path_length(G, 0)
    got = demo.oracle(rows, cols, n, wts)
    assert got.keys() == want.keys() and len(got) == n
    assert all(abs(got[v] - d) < 1e-9 for v, d in want.items())


def _betweenness():
    from demo_torch import graphs

    demo = _load("09")
    rows, cols, n = demo.graph()
    nx, G = _nx_graph(rows, cols, n)
    # networkx counts each unordered pair once on an undirected graph
    want = nx.betweenness_centrality_subset(
        G, sources=demo.SOURCES, targets=list(range(n)), normalized=False)
    got = graphs.brandes(rows, cols, n, demo.SOURCES)
    assert np.allclose(got, 2.0 * np.array([want[i] for i in range(n)]),
                       rtol=1e-12, atol=1e-9)


def _modularity():
    from demo_torch import graphs

    demo = _load("10")
    rows, cols, n = demo.graph()
    nx, G = _nx_graph(rows, cols, n)
    for labels in (np.arange(n) // demo.SIZE,
                   np.random.RandomState(0).randint(0, 7, n)):
        comms = [set(np.flatnonzero(labels == c).tolist())
                 for c in np.unique(labels)]
        assert abs(graphs.modularity(rows, cols, n, labels)
                   - nx.community.modularity(G, comms)) < 1e-12


def _triangle_centrality():
    demo = _load("11")
    rows, cols, n = demo.graph()
    nx, G = _nx_graph(rows, cols, n)
    _, y = demo.oracle(rows, cols, n)
    t = nx.triangles(G)
    assert np.array_equal(y / 2, [t[i] for i in range(n)])


ORACLES = {
    "02_pagerank": _pagerank,
    "03_triangle_counting": lambda: _triangle_total("03"),
    "04_ktruss": _k_truss,
    "07_distributed_mesh": lambda: _triangle_total("07"),
    "08_sssp": _sssp,
    "09_betweenness_centrality": _betweenness,
    "10_louvain": _modularity,
    "11_triangle_centrality": _triangle_centrality,
}


@pytest.mark.parametrize("demo", sorted(ORACLES))
def test_oracle_agrees_with_networkx(demo):
    ORACLES[demo]()
