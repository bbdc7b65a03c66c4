"""Seeded random graphs and scipy/numpy oracles for the demo gallery.

The JAX gallery draws its graphs with networkx and checks against
networkx.  This gallery also runs where networkx is absent, so its
graphs come from numpy's seeded generator (the same models, at the same
sizes) and its oracles are numpy and scipy.  A graph is (rows, cols, n):
int64 edge lists, both directions of every undirected edge, no
self-loops, no duplicates.
"""

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


def symmetric(u, v, n):
    """Both directions of the undirected edges (u, v), row-major, with
    self-loops and duplicates dropped."""
    r = np.concatenate([u, v]).astype(np.int64)
    c = np.concatenate([v, u]).astype(np.int64)
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


def gnm(n, m, seed, directed=False):
    """G(n, m): m distinct edges drawn uniformly, no self-loops (for an
    undirected graph, m distinct unordered pairs)."""
    rng = np.random.RandomState(seed)
    if directed:
        # the n * (n - 1) off-diagonal keys, row-major
        k = rng.choice(n * (n - 1), m, replace=False)
        r, c = k // (n - 1), k % (n - 1)
        c = c + (c >= r)
        o = np.lexsort((c, r))
        return r[o].astype(np.int64), c[o].astype(np.int64), n
    iu, ju = np.triu_indices(n, 1)
    k = rng.choice(len(iu), m, replace=False)
    return symmetric(iu[k], ju[k], n)


def powerlaw_cluster(n, m, p, seed):
    """Holme and Kim's growth model (networkx's powerlaw_cluster_graph):
    each new vertex attaches m edges by preferential attachment, each
    after the first closing a triangle with probability p."""
    rng = np.random.RandomState(seed)
    adj = [set() for _ in range(n)]
    repeated = list(range(m))

    def pick(k):
        out = set()
        while len(out) < k:
            out.add(repeated[rng.randint(len(repeated))])
        return list(out)

    for src in range(m, n):
        targets = pick(m)
        t = targets.pop()
        adj[src].add(t)
        adj[t].add(src)
        repeated.append(t)
        count = 1
        while count < m:
            if rng.rand() < p:
                hood = sorted(w for w in adj[t]
                              if w != src and w not in adj[src])
                if hood:
                    w = hood[rng.randint(len(hood))]
                    adj[src].add(w)
                    adj[w].add(src)
                    repeated.append(w)
                    count += 1
                    continue
            t = targets.pop()
            adj[src].add(t)
            adj[t].add(src)
            repeated.append(t)
            count += 1
        repeated.extend([src] * m)
    u = np.repeat(np.arange(n), [len(a) for a in adj])
    v = np.fromiter((w for a in adj for w in sorted(a)), np.int64, len(u))
    return symmetric(u, v, n)


def watts_strogatz(n, k, p, seed):
    """A connected Watts-Strogatz small world: a ring where each vertex
    meets its k nearest neighbours, each edge's far end rewired with
    probability p to a vertex it does not meet yet; drawn again from the
    next seed until connected (networkx's
    connected_watts_strogatz_graph)."""
    for s in range(seed, seed + 100):
        rng = np.random.RandomState(s)
        adj = [set() for _ in range(n)]
        for j in range(1, k // 2 + 1):
            for u in range(n):
                adj[u].add((u + j) % n)
                adj[(u + j) % n].add(u)
        for j in range(1, k // 2 + 1):
            for u in range(n):
                v = (u + j) % n
                if v in adj[u] and rng.rand() < p:
                    w = rng.randint(n)
                    while w == u or w in adj[u]:
                        if len(adj[u]) >= n - 1:
                            break
                        w = rng.randint(n)
                    else:
                        adj[u].discard(v)
                        adj[v].discard(u)
                        adj[u].add(w)
                        adj[w].add(u)
        u = np.repeat(np.arange(n), [len(a) for a in adj])
        v = np.fromiter((w for a in adj for w in sorted(a)), np.int64,
                        len(u))
        rows, cols, n = symmetric(u, v, n)
        ncomp, _ = csgraph.connected_components(adjacency(rows, cols, n))
        if ncomp == 1:
            return rows, cols, n
    raise ValueError("no connected draw in 100 seeds")


def planted_partition(blocks, size, p_in, p_out, seed):
    """`blocks` groups of `size` vertices; each pair joined with
    probability p_in inside a group and p_out across."""
    n = blocks * size
    rng = np.random.RandomState(seed)
    iu, ju = np.triu_indices(n, 1)
    prob = np.where(iu // size == ju // size, p_in, p_out)
    keep = rng.rand(len(iu)) < prob
    return symmetric(iu[keep], ju[keep], n)


def adjacency(rows, cols, n, vals=None):
    """scipy CSR of the graph (unit weights unless `vals`)."""
    if vals is None:
        vals = np.ones(len(rows))
    return sp.csr_matrix((vals, (rows, cols)), (n, n))


def triangles(rows, cols, n):
    """Triangles through each vertex of an undirected graph:
    diag(A @ A @ A) / 2, as the row sums of (A @ A) .* A over 2."""
    S = adjacency(rows, cols, n)
    T = (S @ S).multiply(S)
    return np.asarray(T.sum(axis=1)).ravel() / 2


def pagerank(rows, cols, n, alpha=0.85, tol=1e-12, itermax=1000):
    """PageRank by power iteration with dangling vertices' rank spread
    evenly (networkx's formulation, unit weights)."""
    S = adjacency(rows, cols, n)
    out = np.asarray(S.sum(axis=1)).ravel()
    dangling = out == 0
    P = sp.diags(np.where(dangling, 0.0, 1.0 / np.maximum(out, 1))) @ S
    x = np.full(n, 1.0 / n)
    for _ in range(itermax):
        prev = x
        x = alpha * (P.T @ x + x[dangling].sum() / n) + (1 - alpha) / n
        if np.abs(x - prev).sum() < n * tol:
            break
    return x


def k_truss_edges(rows, cols, n, k):
    """Directed edge count of the k-truss: supports (S @ S) .* S, prune
    below k - 2, until a pass keeps every edge."""
    S = adjacency(rows, cols, n)
    while True:
        C = (S @ S).multiply(S).tocsr()
        C.data[C.data < k - 2] = 0
        C.eliminate_zeros()
        if C.nnz == S.nnz:
            return C.nnz
        S = C
        S.data[:] = 1.0


def brandes(rows, cols, n, sources):
    """Unnormalised betweenness from `sources` to every vertex on the
    unweighted graph (Brandes' accumulation, every ordered pair)."""
    S = adjacency(rows, cols, n)
    indptr, indices = S.indptr, S.indices
    bc = np.zeros(n)
    for s in sources:
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = np.full(n, -1)
        dist[s] = 0
        order, frontier = [s], [s]
        while frontier:
            nxt = []
            for v in frontier:
                for w in indices[indptr[v]:indptr[v + 1]]:
                    if dist[w] < 0:
                        dist[w] = dist[v] + 1
                        nxt.append(w)
                    if dist[w] == dist[v] + 1:
                        sigma[w] += sigma[v]
            order += nxt
            frontier = nxt
        delta = np.zeros(n)
        for w in reversed(order):
            for v in indices[indptr[w]:indptr[w + 1]]:
                if dist[v] == dist[w] - 1:
                    delta[v] += sigma[v] / sigma[w] * (1.0 + delta[w])
            if w != s:
                bc[w] += delta[w]
    return bc


def modularity(rows, cols, n, labels):
    """Newman's modularity of `labels` on the unit-weight graph: the
    sum over communities of inner weight / 2m - (degree sum / 2m)^2."""
    S = adjacency(rows, cols, n)
    k = np.asarray(S.sum(axis=1)).ravel()
    two_m = float(k.sum())
    inner = float((labels[rows] == labels[cols]).sum())
    tot = np.bincount(labels, weights=k)
    return inner / two_m - float(((tot / two_m) ** 2).sum())
