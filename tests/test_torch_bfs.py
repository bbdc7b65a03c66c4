"""The direction-optimised BFS of the port against the JAX package on
the CPU: ``fused.bfs_frontier`` (the device frontier loop, its retry
and its dense fallback), ``algorithms.bfs_level`` on both sides of its
32768-entry switch to the frontier loop, and ``algorithms.bfs_parents``,
whose parents must be equal to the JAX package's (the same numpy over
the same CSR), not merely valid.  Levels are compared exactly."""

import networkx as nx
import numpy as np
import pytest

import pygraphblas_tpu as J
import pygraphblas_tpu_torch as T
from pygraphblas_tpu import algorithms as jalg, fused as jfused
from pygraphblas_tpu_torch import algorithms as talg, fused as tfused


def _pair(rows, cols, n):
    """The same BOOL matrix in both packages (the port's on the CPU)."""
    r = np.asarray(rows, np.int64)
    c = np.asarray(cols, np.int64)
    out = []
    for pkg, kw in ((J, {}), (T, dict(device="cpu"))):
        A = pkg.Matrix.sparse(pkg.types.BOOL, n, n, **kw)
        A._build(r, c, np.ones(len(r), np.bool_))
        out.append(A)
    return out


def _undirected(G):
    G = nx.convert_node_labels_to_integers(G)
    rows, cols = [], []
    for u, v in G.edges():
        rows += [u, v]
        cols += [v, u]
    return _pair(rows, cols, G.number_of_nodes())


GRAPHS = {
    "gnm": lambda: nx.gnm_random_graph(3000, 9000, seed=1),
    "tree": lambda: nx.random_labeled_tree(1500, seed=2),
    "grid": lambda: nx.grid_2d_graph(50, 50),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_frontier_matches_jax(name):
    """The frontier loop's levels equal the JAX package's frontier loop
    and its host push/pull BFS; no budget overflows."""
    JA, TA = _undirected(GRAPHS[name]())
    want = dict(jfused.bfs_frontier(JA, 0))
    got = dict(tfused.bfs_frontier(TA, 0, device="cpu"))
    assert got == want == dict(jalg.bfs_level(JA, 0))
    assert tfused.last_frontier["route"] == "frontier"
    assert tfused.last_frontier["levels_run"] == max(want.values())


def test_bfs_frontier_isolated_start():
    JA, TA = _pair([1, 2], [2, 3], 10)
    for s in (0, 1):
        assert dict(tfused.bfs_frontier(TA, s, device="cpu")) == \
            dict(jfused.bfs_frontier(JA, s))
    assert dict(tfused.bfs_frontier(TA, 1, device="cpu")) == \
        {1: 1, 2: 2, 3: 3}


def test_bfs_frontier_directed_chain():
    """Edges i -> i+1 only: from the middle, the suffix alone."""
    n = 300
    JA, TA = _pair(np.arange(n - 1), np.arange(1, n), n)
    got = dict(tfused.bfs_frontier(TA, 100, device="cpu"))
    assert got == dict(jfused.bfs_frontier(JA, 100))
    assert got == {100 + k: k + 1 for k in range(n - 100)}


@pytest.mark.parametrize("p_bits, route", [(4, "dense"), (9, "retry")])
def test_bfs_frontier_overflow(p_bits, route):
    """A frontier past the id buffer retries once with budgets 4x, then
    falls back to the dense fused.bfs_level: the same levels."""
    JA, TA = _undirected(nx.gnm_random_graph(2000, 20000, seed=5))
    want = dict(jfused.bfs_frontier(JA, 0, p_bits=p_bits))
    got = dict(tfused.bfs_frontier(TA, 0, p_bits=p_bits, device="cpu"))
    assert got == want
    assert tfused.last_frontier["route"] == route


def test_bfs_frontier_empty_matrix_takes_the_host_loop():
    JA, TA = _pair([], [], 5)
    assert dict(tfused.bfs_frontier(TA, 2, device="cpu")) == \
        dict(jfused.bfs_frontier(JA, 2)) == {2: 1}


def _kron(scale, ef):
    from pygraphblas_tpu_torch.generators import rmat_edges

    rows, cols, n = rmat_edges(scale, ef)
    return _pair(rows, cols, n)


@pytest.mark.parametrize("scale, ef, frontier",
                         [(10, 8, False), (12, 16, True)])
def test_bfs_level_both_sides_of_the_switch(scale, ef, frontier):
    """algorithms.bfs_level: the host loop under 32768 entries, the
    frontier loop from there (kron graphs: directed, skewed)."""
    JA, TA = _kron(scale, ef)
    assert (32768 <= TA.nvals) == frontier
    tfused.last_frontier.clear()
    for s in (0, 7):
        want = dict(jalg.bfs_level(JA, s))
        assert dict(talg.bfs_level(TA, s)) == want
        assert dict(talg.bfs_level_vxm(TA, s)) == want
    assert bool(tfused.last_frontier) == frontier


@pytest.mark.parametrize("which", ["gnm", "kron11"])
def test_bfs_parents_equal_jax(which):
    """Parents equal to the JAX package's, entry for entry; each
    parent's level is its child's less one."""
    if which == "gnm":
        JA, TA = _undirected(nx.gnm_random_graph(2000, 8000, seed=3))
    else:
        JA, TA = _kron(11, 16)
    for s in (0, 5):
        want = dict(jalg.bfs_parents(JA, s))
        got = dict(talg.bfs_parents(TA, s))
        assert got == want
        lv = dict(talg.bfs_level(TA, s))
        assert set(got) == set(lv)
        assert all(lv[p] == lv[c] - 1 for c, p in got.items() if c != s)


def test_algorithms_lack_nothing_of_jax():
    """Every name of the JAX package's algorithms.__all__ is in the
    port's, and is callable."""
    assert set(jalg.__all__) <= set(talg.__all__)
    assert all(callable(getattr(talg, n)) for n in jalg.__all__)
