"""Graph algorithms over the GraphBLAS containers and the masked SpGEMM.

Counterpart of ``pygraphblas_tpu/algorithms.py``: the user-level codes
written, as the JAX package writes them, as masked semiring mxv/vxm/mxm
loops over :class:`Matrix` and :class:`Vector` (``bfs_level_vxm``,
``bfs_parents_vxm``, ``pagerank``, ``sssp``, ``betweenness_centrality``,
``triangle_centrality``, and ``triangle_count`` methods "cohen" and
"sandia_dot"), the two that run on canonical host COO arrays feeding
``core/spgemm.py:masked_spgemm`` directly with INT64 PLUS_PAIR
(``triangle_count`` method "sandia", ``k_truss``), and Louvain
(``louvain_cluster``: host gain arithmetic around one unmasked
``Matrix.mxm`` a chunk of vertices, ESC's kernels on the card).

Each runs on `device` (default: the matrix's own device, else the CUDA
card; with no card and no device named it raises).  A matrix that holds
no device yet takes the one named."""

import time

import numpy as np

from . import descriptor, types
from ._device import resolve_device
from .core import spgemm as gk
from .core.coosparse import build as _cbuild
from .core.spmspv import expand_segments
from .matrix import Matrix
from .vector import Vector

__all__ = ["bfs_level", "bfs_level_vxm", "bfs_parents", "bfs_parents_vxm",
           "pagerank", "sssp", "triangle_count", "betweenness_centrality",
           "k_truss", "triangle_centrality", "louvain_cluster", "dnn",
           "hypergraph", "hyperdnn", "relu_neuron_semiring"]

# host seconds by phase ("relabel+build"; Louvain's "louvain extract",
# "louvain mxm", "louvain moves" and "louvain contract") summed over
# calls since seconds.clear(); core/spgemm.stats holds masked_spgemm's
# own phases
seconds = {}


def _device_of(A, device):
    """The device an algorithm on A runs on: `device` if named (A takes
    it if it holds none; ValueError if it holds another), else A's own,
    else the card."""
    if device is not None:
        dev = resolve_device(device)
        if A._dev is not None and str(A._dev) != str(dev):
            raise ValueError(f"the matrix is on {A._dev}, not {dev}")
        A._dev = dev
        return dev
    return A._device()


def bfs_level(A, start, device=None):
    """Level-synchronous BFS: a vector of 1-based levels.  For 32768 to
    2**31 entries, the device frontier loop (``fused.bfs_frontier``);
    otherwise the host push/pull loop: small frontiers expand by sorted
    search and neighbour dedup, large ones by O(n) marking."""
    dev = _device_of(A, device)
    n = A.nrows
    if 32768 <= A.nvals < 2**31 and n < 2**31:
        from . import fused

        return fused.bfs_frontier(A, start, device=dev)
    u, s, d, outs, _ = A._host_csr(in_is_col=False)
    levels = np.zeros(n, np.int64)
    visited = np.zeros(n, bool)
    frontier = np.asarray([start], np.int64)
    visited[start] = True
    level = 1
    while frontier.size:
        levels[frontier] = level
        st, dg = gk._row_lookup(u, s, d, frontier)
        _, offs = expand_segments(st, dg)
        nbr = outs[offs]
        if nbr.size * 32 < n:           # push: dedup the neighbour list
            nxt = np.unique(nbr)
            nxt = nxt[~visited[nxt]]
        else:                           # pull-ish: O(n) marking
            mark = np.zeros(n, bool)
            mark[nbr] = True
            nxt = np.nonzero(mark & ~visited)[0]
        visited[nxt] = True
        frontier = nxt
        level += 1
    i = np.nonzero(levels)[0]
    v = Vector.sparse(types.INT64, n, device=dev)
    v._build(i, levels[i])
    return v


def bfs_parents(A, start, device=None):
    """BFS parent tree on the host CSR: 0-based parent ids (the start's
    parent is itself); within a level later writes win, as numpy's
    fancy assignment orders them ("ANY" parent semantics)."""
    dev = _device_of(A, device)
    n = A.nrows
    u, s, d, outs, _ = A._host_csr(in_is_col=False)
    parents = np.full(n, -1, np.int64)
    frontier = np.asarray([start], np.int64)
    parents[start] = start
    while frontier.size:
        st, dg = gk._row_lookup(u, s, d, frontier)
        ent, offs = expand_segments(st, dg)
        nbr = outs[offs]
        src = frontier[ent]
        new = parents[nbr] < 0
        nbr, src = nbr[new], src[new]
        parents[nbr] = src
        frontier = np.unique(nbr)
    i = np.nonzero(parents >= 0)[0]
    pi = Vector.sparse(types.INT64, n, device=dev)
    pi._build(i, parents[i])
    return pi


def bfs_level_vxm(A, start, device=None):
    """The masked-vxm BFS loop: a vector of 1-based levels."""
    dev = _device_of(A, device)
    n = A.nrows
    v = Vector.sparse(types.INT64, n, device=dev)
    q = Vector.sparse(types.BOOL, n, device=dev)
    q[start] = True
    level = 1
    while q.reduce_bool() and level <= n:
        v.assign_scalar(level, mask=q)
        q = q.vxm(A, semiring=types.BOOL.lor_land, mask=v,
                  desc=descriptor.RC)
        level += 1
    return v


def bfs_parents_vxm(A, start, device=None):
    """BFS parent tree via the ANY_SECONDI semiring: 0-based parent ids
    (the start's parent is itself)."""
    dev = _device_of(A, device)
    n = A.nrows
    pi = Vector.sparse(types.INT64, n, device=dev)
    q = Vector.sparse(types.INT64, n, device=dev)
    q[start] = start
    pi[start] = start
    while q.nvals > 0:
        # SECONDI: the matrix entry's row index k == the parent id
        q = q.vxm(A, semiring=types.INT64.any_secondi, mask=pi,
                  desc=descriptor.RSC)
        if q.nvals == 0:
            break
        pi.assign(q, mask=q, desc=descriptor.S)
    return pi


def pagerank(A, damping=0.85, itermax=100, tol=1e-4, d=None, device=None):
    """PageRank, the GAP formulation: a transposed PLUS_SECOND mxv with
    degree-normalized ranks, accumulated with PLUS into the teleport
    term (``A.mxv(w, accum=PLUS, desc=T0)``)."""
    dev = _device_of(A, device)
    n = A.nrows
    if d is None:
        d = A.reduce_vector(types.FP32.PLUS_MONOID, cast=types.FP32)
        d = d.eadd(Vector.dense(types.FP32, n, fill=0.0, device=dev),
                   types.FP32.FIRST)
    r = Vector.sparse(types.FP32, n, device=dev)
    t = Vector.sparse(types.FP32, n, device=dev)
    d = d.apply_second(types.FP32.DIV, damping)
    r[:] = 1.0 / n
    teleport = (1 - damping) / n
    rdiff = 1.0
    for _ in range(itermax):
        if rdiff <= tol:
            break
        temp = t
        t = r
        r = temp
        w = t.emult(d, types.FP32.DIV)
        r.assign_scalar(teleport)
        A.mxv(w, out=r, accum=types.FP32.PLUS,
              semiring=types.FP32.plus_second, desc=descriptor.T0)
        t -= r
        t.apply(types.FP32.ABS, out=t)
        rdiff = t.reduce_float()
    return r


def sssp(A, start, device=None):
    """Single-source shortest paths: MIN_PLUS vxm with a MIN
    accumulator, until the distances stop changing."""
    dev = _device_of(A, device)
    n = A.nrows
    v = Vector.sparse(A.type, n, device=dev)
    v[start] = 0
    for _ in range(n):
        w = v.dup()
        v = v.vxm(A, semiring=getattr(A.type, "MIN_PLUS"),
                  accum=getattr(A.type, "MIN"), out=v)
        if w.iseq(v):
            break
    return v


def _relabel_by_degree(r, c, n):
    """Vertex ranks by ascending degree (the GAP ordering)."""
    deg = np.bincount(r, minlength=n)
    perm = np.argsort(deg, kind="stable")
    rank = np.empty_like(perm)
    rank[perm] = np.arange(len(perm))
    return rank[r], rank[c]


def triangle_count(A, method="sandia", order_by_degree=True, device=None):
    """Count triangles in the undirected graph A (boolean-symmetric).

    Methods:
    - "sandia":     (L @ L)<L> INT64 PLUS_PAIR, summed: relabel, tril and
                    canonicalize in one host pass into masked_spgemm;
    - "cohen":      (L @ U)<A> PLUS_PAIR through the containers, total / 2;
    - "sandia_dot": (L @ U.T)<L> through the containers (the T1
                    descriptor).

    `order_by_degree` relabels vertices by ascending degree first (the
    GAP ordering): with power-law hubs the lower-triangle lists stay
    short, which bounds the per-edge intersection.  The count does not
    depend on the labels."""
    if method not in ("sandia", "cohen", "sandia_dot"):
        raise ValueError(f"unknown method {method}")
    sr = types.INT64.PLUS_PAIR
    if method == "sandia":
        dev = resolve_device(device) if device is not None \
            else (A._dev or resolve_device(None))
        t0 = time.perf_counter()
        r, c, _ = A._coo()
        if order_by_degree:
            r, c = _relabel_by_degree(r, c, max(A.nrows, A.ncols))
        keep = r > c
        lr, lc = r[keep], c[keep]
        ones = np.ones(len(lr), np.int64)
        lr, lc, ones = _cbuild(lr, lc, ones, np.int64)
        btr, btc, _ = _cbuild(lc, lr, ones, np.int64)
        gk.add_seconds(seconds, "relabel+build", t0)
        _, _, vv = gk.masked_spgemm(lr, lc, ones, btr, btc, ones, lr, lc,
                                    sr, np.int64, device=dev)
        return int(vv.sum())

    dev = _device_of(A, device)
    if order_by_degree:
        t0 = time.perf_counter()
        r, c, v = A._coo()
        rr, rc = _relabel_by_degree(r, c, max(A.nrows, A.ncols))
        relabeled = Matrix.sparse(A.type, A.nrows, A.ncols, device=dev)
        relabeled._build(rr, rc, np.asarray(v))
        A = relabeled
        gk.add_seconds(seconds, "relabel+build", t0)
    L = A.tril(-1)
    if method == "cohen":
        C = L.mxm(A.triu(1), semiring=sr, mask=A, cast=types.INT64)
        return C.reduce_int() // 2
    C = L.mxm(A.triu(1), semiring=sr, mask=L, cast=types.INT64,
              desc=descriptor.T1)
    return C.reduce_int()


def betweenness_centrality(A, sources, AT=None, device=None):
    """Batched Brandes betweenness centrality: a forward masked
    PLUS_FIRST SpMM over a batch of source frontiers, then a backward
    dependency sweep."""
    dev = _device_of(A, device)
    if AT is None:
        AT = A.T
    n = A.nrows
    ns = len(sources)
    paths = Matrix.dense(types.FP32, ns, n, fill=0.0, device=dev)
    frontier = Matrix.sparse(types.FP32, ns, n, device=dev)
    for i, s in enumerate(sources):
        paths[i, s] = 1.0
        frontier[i, s] = 1.0

    # forward: expand frontiers until exhausted, snapshotting levels
    S = []
    frontier = frontier.mxm(A, semiring=types.FP32.plus_first,
                            mask=paths, desc=descriptor.RC)
    while frontier.nvals != 0:
        S.append(frontier.pattern())
        paths.assign_matrix(frontier, accum=types.FP32.PLUS)
        frontier = frontier.mxm(A, semiring=types.FP32.plus_first,
                                mask=paths, desc=descriptor.RC)

    bc = Matrix.dense(types.FP32, ns, n, fill=1.0, device=dev)

    # backward dependency accumulation
    for i in range(len(S) - 1, 0, -1):
        W = bc.emult(paths, types.FP32.DIV, mask=S[i], desc=descriptor.RS)
        W = W.mxm(AT, semiring=types.FP32.plus_first, mask=S[i - 1],
                  desc=descriptor.RS)
        W.emult(paths, types.FP32.TIMES, out=bc, accum=types.FP32.PLUS)

    centrality = bc.reduce_vector(types.FP32.PLUS_MONOID,
                                  desc=descriptor.T0)
    return centrality.apply_second(types.FP32.MINUS, float(ns))


def k_truss(A, k, device=None):
    """k-truss subgraph: every kept edge lies in >= k-2 triangles of
    the kept graph.  Returns an INT64 Matrix of the kept edges' supports
    (their triangle counts).

    Each pass is one masked PLUS_PAIR product C<A> = A @ A on the kept
    edges, which drops edges of no support, then a prune below k-2;
    passes end when a pass keeps every edge."""
    dev = resolve_device(device) if device is not None \
        else (A._dev or resolve_device(None))
    r, c, _ = A._coo()
    r = np.asarray(r, np.int64)
    c = np.asarray(c, np.int64)
    nvals_last = -1
    while True:
        t0 = time.perf_counter()
        ones = np.ones(len(r), np.int64)
        btr, btc, _ = _cbuild(c, r, ones, np.int64)
        gk.add_seconds(seconds, "relabel+build", t0)
        cnt_r, cnt_c, support = gk.masked_spgemm(
            r, c, ones, btr, btc, ones, r, c, types.INT64.PLUS_PAIR,
            np.int64, device=dev)
        keep = support >= (k - 2)
        r, c, support = cnt_r[keep], cnt_c[keep], support[keep]
        if len(r) == nvals_last:
            out = Matrix.sparse(types.INT64, A.nrows, A.ncols, device=dev)
            out._build(r, c, support)
            return out
        nvals_last = len(r)


def triangle_centrality(A, device=None):
    """Triangle centrality (Burkhardt 2021): importance by triangle
    participation, TC = (3 A y - 2 T' y + y) / k."""
    dev = _device_of(A, device)
    T = A.mxm(A, semiring=types.FP64.plus_pair, mask=A, cast=types.FP64)
    y = T.reduce_vector(types.FP64.PLUS_MONOID)
    k = y.reduce_float()
    if k == 0:
        return Vector.dense(types.FP64, A.nrows, fill=0.0, device=dev)
    T_pattern = T.pattern(types.FP64)
    yp = T_pattern.mxv(y, semiring=types.FP64.plus_second)
    center = A.mxv(y, semiring=types.FP64.plus_second)
    out = center.apply_second(types.FP64.TIMES, 3.0)
    out = out.eadd(yp.apply_second(types.FP64.TIMES, -2.0), types.FP64.PLUS)
    out = out.eadd(y, types.FP64.PLUS)
    return out.apply_second(types.FP64.DIV, k)


def _louvain_local_moves(W, kv, two_m, max_iters, nchunks=32, seed=0):
    """One Louvain local-move phase.  Each sweep visits the vertices in
    shuffled chunks; a chunk's per-(vertex, candidate community) edge
    weights are one semiring product

        H = W[chunk, :] @ M,   M[j, c] = 1 iff labels[j] == c

    (FP32 PLUS_TIMES: ``Matrix.extract_matrix`` then ``Matrix.mxm``,
    the unmasked SpGEMM tiers; while labels are the identity M is the
    identity, so the product takes the diagonal-B path), and M is built
    from the current labels, so a chunk sees the sweep's earlier moves.
    The gains are host float64 arithmetic.  Returns compacted labels."""
    n = W.nrows
    dev = W._device()
    labels = np.arange(n, dtype=np.int64)
    comm_deg = kv.astype(np.float64).copy()
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    chunks = np.array_split(order, min(nchunks, max(1, n // 64)))
    wr, wc, wv = W._coo()
    self_w = np.zeros(n, np.float64)
    dsel = wr == wc
    self_w[wr[dsel]] = wv[dsel].astype(np.float64)
    ones = np.ones(n, np.float32)
    vids = np.arange(n, dtype=np.int64)
    M = None

    for _ in range(max_iters):
        moved = 0
        for chunk in chunks:
            if chunk.size == 0:
                continue
            t0 = time.perf_counter()
            Wc = W.extract_matrix(chunk.tolist())
            t1 = gk.add_seconds(seconds, "louvain extract", t0)
            if M is None:      # membership matrix of the current labels
                M = Matrix.sparse(types.FP32, n, n, device=dev)
                M._build(vids, labels, ones)
            H = Wc.mxm(M, semiring=types.FP32.PLUS_TIMES)
            hr, hc, hv = H._coo()
            t0 = gk.add_seconds(seconds, "louvain mxm", t1)
            hv = hv.astype(np.float64)
            # a self-loop does not vote for a move
            sw = self_w[chunk]
            srows = np.nonzero(sw)[0]
            if srows.size and len(hr):
                want = hr * np.int64(n) + hc
                skey = srows * np.int64(n) + labels[chunk[srows]]
                pos = np.searchsorted(want, skey)
                posc = np.minimum(pos, len(want) - 1)
                hit = want[posc] == skey
                np.subtract.at(hv, posc[hit], sw[srows][hit])
            row_ptr = np.searchsorted(hr, np.arange(chunk.size + 1))
            lens = row_ptr[1:] - row_ptr[:-1]
            total = int(lens.sum())
            if total == 0:
                gk.add_seconds(seconds, "louvain moves", t0)
                continue
            g_ent = np.repeat(np.arange(chunk.size), lens)
            g_src = chunk[g_ent]
            g_cand = hc
            w_in = hv
            cur = labels[g_src]
            ki = kv[g_src].astype(np.float64)
            # the gain of joining g_cand, with i out of its community
            other = (comm_deg[g_cand]
                     - np.where(g_cand == cur, kv[g_src], 0.0))
            gain = w_in - other * ki / two_m
            # staying: the g_cand == cur entry where there is one, else
            # the empty community's baseline
            stay_base = -(comm_deg[cur] - ki) * ki / two_m
            is_cur = g_cand == cur
            stay_per_v = np.full(chunk.size, 0.0)
            has_cur = np.zeros(chunk.size, bool)
            stay_per_v[g_ent[is_cur]] = gain[is_cur]
            has_cur[g_ent[is_cur]] = True
            base_per_v = np.zeros(chunk.size)
            base_per_v[g_ent] = stay_base
            stay_v = np.where(has_cur, stay_per_v, base_per_v)
            # each vertex's best candidate: the last of its group sorted
            # by (vertex, gain)
            o2 = np.lexsort((gain, g_ent))
            ge, gg, gc = g_ent[o2], gain[o2], g_cand[o2]
            last = np.ones(ge.size, bool)
            last[:-1] = ge[1:] != ge[:-1]
            be, bg, bc = ge[last], gg[last], gc[last]
            vsrc = chunk[be]
            do = bg > stay_v[be] + 1e-12
            vsrc, bc = vsrc[do], bc[do]
            changed = labels[vsrc] != bc
            vsrc, bc = vsrc[changed], bc[changed]
            if vsrc.size:
                np.subtract.at(comm_deg, labels[vsrc], kv[vsrc])
                np.add.at(comm_deg, bc, kv[vsrc])
                labels[vsrc] = bc
                moved += vsrc.size
                M = None       # the membership changed
            gk.add_seconds(seconds, "louvain moves", t0)
        if moved == 0:
            break
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def louvain_cluster(A, max_iters=20, max_levels=10, seed=None, device=None):
    """Louvain community detection: local modularity-gain moves, then
    the communities contracted into a weighted graph, W = P^T (W P)
    (two FP32 PLUS_TIMES products, P[i, labels[i]] = 1), repeated until
    no vertex moves or `max_levels`.  Returns an INT64 Vector of
    community labels.  As in the JAX package, the sweeps' vertex order
    is ``RandomState(0)``'s whatever `seed` says."""
    dev = _device_of(A, device)
    n = A.nrows
    W = A.cast(types.FP32)
    mapping = np.arange(n, dtype=np.int64)
    two_m = None
    for _ in range(max_levels):
        t0 = time.perf_counter()
        nw = W.nrows
        kvec = W.reduce_vector(types.FP32.PLUS_MONOID)
        kv = np.zeros(nw, np.float64)
        ki, kvv = kvec._coo()
        kv[ki] = kvv
        gk.add_seconds(seconds, "louvain contract", t0)
        if two_m is None:
            two_m = float(kv.sum())
            if two_m == 0:
                return Vector.from_lists(list(range(n)), list(range(n)), n,
                                         device=dev)
        labels = _louvain_local_moves(W, kv, two_m, max_iters)
        ncomm = int(labels.max()) + 1
        if ncomm == nw:
            break
        mapping = labels[mapping]
        if ncomm == 1:
            break
        t0 = time.perf_counter()
        P = Matrix.sparse(types.FP32, nw, ncomm, device=dev)
        P._build(np.arange(nw, dtype=np.int64), labels,
                 np.ones(nw, np.float32))
        W = P.transpose().mxm(W.mxm(P, semiring=types.FP32.PLUS_TIMES),
                              semiring=types.FP32.PLUS_TIMES)
        gk.add_seconds(seconds, "louvain contract", t0)

    out = Vector.sparse(types.INT64, n, device=dev)
    out._build(np.arange(n, dtype=np.int64), mapping.astype(np.int64))
    return out


# ---------------------------------------------------------------------------
# GraphChallenge sparse DNN inference over the containers
# ---------------------------------------------------------------------------

def hypergraph(mt, size=None, typ=None, diag=False):
    """Assemble a list of matrices into one hypersparse block matrix:
    block row l holds layer l, shifted one block column right, so that
    one mxm advances activations through every layer at once.  With
    ``diag=True`` block l sits at (l+1, l+1) instead: the layout for
    per-layer bias matrices, applied in place to activations that just
    hopped into block l+1.  On the first matrix's device."""
    if size is None:
        size = sum(m.nrows for m in mt) + mt[-1].nrows
    typ = typ or mt[0].type
    rows_all, cols_all, vals_all = [], [], []
    ioffset = 0
    joffset = 0
    for m in mt:
        joffset += m.nrows
        r, c, v = m._coo()
        rows_all.append(r + (joffset if diag else ioffset))
        cols_all.append(c + joffset)
        vals_all.append(v)
        ioffset += m.nrows
    R = Matrix.sparse(typ, size, size, device=mt[0].device)
    R._build(np.concatenate(rows_all), np.concatenate(cols_all),
             np.concatenate(vals_all).astype(typ._numpy_t))
    return R


def relu_neuron_semiring(clip=32.0):
    """The GraphChallenge ReLU semiring: mul(x, b) = min(max(x + b, 0),
    clip) applies the bias, the ReLU and the clip inside the mxm; the
    add monoid is MAX."""
    import torch

    from .binaryop import binary_op

    clip32 = float(np.float32(clip))

    @binary_op(types.FP32)
    def RELU_TIMES(x, y):
        return torch.clamp(x + y, 0.0, clip32)

    mon = types.FP32.new_monoid(types.FP32.MAX, types.FP32.default_one)
    return types.FP32.new_semiring(mon, RELU_TIMES)


def hyperdnn(nlayers, W, B, Y):
    """Hypersparse DNN inference: W and B are whole-net `hypergraph`
    block matrices (B built with ``diag=True``); each iteration moves
    every image one layer on by two mxms, with the bias, the ReLU and
    the clip inside the second (`relu_neuron_semiring`)."""
    sem = relu_neuron_semiring()
    for _ in range(nlayers):
        Y = Y @ W
        Y = Y.mxm(B, semiring=sem)
        Y = Y.select(">0")
    return Y


def dnn(W, B, Y):
    """GraphChallenge sparse DNN inference: each layer Y @ W, the bias
    through PLUS_PLUS, the ReLU as a select, the clip at 32 as a masked
    assign."""
    for w, b in zip(W, B):
        Y = Y @ w
        with types.FP32.PLUS_PLUS:
            Y = Y.mxm(b)
        Y = Y.select(">0")
        M = Y.select(">", 32)
        if len(M):
            Y[M] = 32
    return Y
