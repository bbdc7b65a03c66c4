"""Whole-loop algorithms over the xspmv engine: PageRank, BFS, SSSP and
betweenness centrality.

Counterpart of ``pygraphblas_tpu/fused.py`` (``pagerank``,
``_pagerank_loop_coo``, ``_deg_vec``, ``bfs_level``, ``bfs_batch``,
``sssp``, ``bc``).  The JAX package compiles each loop into one XLA
program (``lax.while_loop``); here it is a Python loop of kernel
launches on one CUDA stream, with the same loop conditions.  Each step
of a loop whose end depends on the data reads one scalar back to the
host (PageRank with ``tol >= 0``: ``rdiff``; BFS and BC: whether the
frontier is empty; SSSP: whether a distance changed).  Nothing else
leaves the card.  PageRank with ``tol < 0`` runs exactly ``itermax``
iterations and reads nothing.

Where the xspmv engine does not apply (nnz below ``MIN_NNZ``,
``spmv_engine="csr8"``, integer SSSP) the loops run over the matrix's
csr8 plan (``core/csr8.py``: torch gathers and folds on the device), as
the JAX package's do; BC there, and on a non-square matrix, is
``algorithms.betweenness_centrality``.  With ``spmv_plan_async`` a cold
PageRank plan builds in a thread while the planless COO loop runs.
Integer SSSP takes the csr8 plan's masked SpMV, so no value stands for
infinity (the JAX package's loop casts inf to the integer type, which
raises ``OverflowError``).
"""

import numpy as np
import torch

from . import types
from ._device import resolve_device
from .base import config
from .core import csr8
from .core import xspmv as xs
from .vector import Vector

__all__ = ["pagerank", "bfs_level", "bfs_batch", "bfs_frontier", "sssp",
           "bc", "dnn"]


def _xspmv_ok(A, semiring, dtype):
    if config.spmv_engine == "csr8":
        return False
    if config.spmv_engine == "xspmv":
        return True
    return xs.supported(semiring, dtype, A.nvals)


def _csr8_spmv(plan, x, mul, add, ident, ident_x):
    """Semiring SpMV over a csr8 plan with dense x (fused.py:_spmv): the
    pad column reads a trailing x cell holding `ident_x`."""
    x_ext = torch.cat([x, ident_x.reshape(1)])
    prod = mul(plan.vals_p.to(x.dtype), x_ext[plan.cols_p])
    return csr8.reduce_partials(plan, prod, add, ident)


def _deg_vec(A, device=None):
    """Out-degrees as float32 on `device` (cached per device)."""
    dev = resolve_device(device)
    cache = A._cache()
    key = ("deg", str(dev))
    if key not in cache:
        r_host, _, _ = A._coo()
        deg_h = np.zeros(A.nrows, np.float32)
        np.add.at(deg_h, r_host, 1.0)
        cache[key] = torch.from_numpy(deg_h).to(dev)
    return cache[key]


def _d_inv(deg, damping):
    # float32 division, as the JAX package's damping / maximum(deg, 1)
    num = torch.full_like(deg, damping)
    d = torch.where(deg > 0, num / torch.clamp(deg, min=1.0),
                    torch.zeros_like(deg))
    return d.to(torch.float32)


def _loop(spmv, n, itermax, d_inv_damped, teleport, tol):
    """r <- teleport + spmv(r * d_inv) while rdiff > tol, at most
    itermax times.  Returns (r, rdiff, iterations)."""
    dev = d_inv_damped.device
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    teleport = torch.tensor(teleport, dtype=torch.float32, device=dev)
    rdiff = torch.tensor(np.inf, dtype=torch.float32, device=dev)
    i = 0
    while i < itermax:
        if tol >= 0 and not float(rdiff) > tol:
            break
        w = r * d_inv_damped
        r_new = teleport + spmv(w)
        rdiff = torch.sum(torch.abs(r_new - r))
        r = r_new
        i += 1
    return r, rdiff, i


def _pagerank_loop_coo(rows, cols, n, itermax, d_inv_damped, teleport,
                       tol):
    """Planless PageRank loop over raw COO triples (gather + index_add_).

    No plan and no kernel of the port: the oracle that the fused engine
    is checked against."""
    rows = rows.long()
    cols = cols.long()

    def spmv(w):
        out = torch.zeros(n, dtype=torch.float32, device=w.device)
        return out.index_add_(0, cols, w[rows])

    return _loop(spmv, n, itermax, d_inv_damped, teleport, tol)


def pagerank(A, damping=0.85, itermax=100, tol=1e-4, device=None):
    """Whole-loop PageRank; returns a dense FP32 Vector on `device`
    (default: the CUDA card).  Uses the gather-free xspmv engine where
    it applies (the hand kernels on the card), else the csr8 plan; with
    ``spmv_plan_async`` a cold plan builds in a thread while the
    planless COO loop runs."""
    dev = resolve_device(device)
    n = A.nrows
    sem = types.FP32.PLUS_SECOND
    d_inv = _d_inv(_deg_vec(A, dev), damping)
    teleport = np.float32((1 - damping) / n)
    if _xspmv_ok(A, sem, np.float32):
        plan = A._xspmv_plan(True, np.float32, device=dev,  # y = A^T w
                             async_build=config.spmv_plan_async)
        if plan is None:            # build in flight: the planless loop
            rows, cols, _ = A._device_coo(dev)
            r, _, _ = _pagerank_loop_coo(rows, cols, n, itermax, d_inv,
                                         teleport, tol)
        else:
            def spmv(w):
                return xs.xspmv(plan, w, sem, np.float32)[0]

            r, _, _ = _loop(spmv, n, itermax, d_inv, teleport, tol)
    else:
        plan = A._spmv_plan(True, dev)                  # transposed
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def spmv(w):
            return _csr8_spmv(plan, w, lambda a, x: x, "PLUS", zero, zero)

        r, _, _ = _loop(spmv, n, itermax, d_inv, teleport, tol)
    return Vector._from_parts(types.FP32, r)


def _bfs_one(plan, n, start, dev):
    """Level-synchronous BFS from `start` (fused.py:230-247): MAX_SECOND
    over a 0/1 float32 frontier (LOR on {0, 1} is MAX).  Returns int32
    levels, 1-based, 0 where unreached."""
    sem = types.FP32.MAX_SECOND
    lv = torch.zeros(n, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n, dtype=torch.float32, device=dev)
    frontier[start] = 1.0
    level = 1
    # cond: any(frontier > 0) and level <= n -- one scalar a step
    while level <= n and bool((frontier > 0).any()):
        lv = torch.where(frontier > 0, level, lv)
        nxt, _ = xs.xspmv(plan, frontier, sem, np.float32)
        frontier = torch.where(lv == 0, nxt.clamp_min(0.0), 0.0)
        level += 1
    return lv


def _bfs_csr8(plan, n, start, dev):
    """The level loop over a csr8 plan: LOR of the frontier's pattern
    (fused.py:_bfs_loop).  Returns int32 levels, 1-based, 0 where
    unreached."""
    lv = torch.zeros(n, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[start] = True
    zero = torch.zeros((), dtype=torch.int8, device=dev)
    level = 1
    while level <= n and bool(frontier.any()):
        lv = torch.where(frontier, level, lv)
        f_ext = torch.cat([frontier, torch.zeros(1, dtype=torch.bool,
                                                 device=dev)])
        fe = (f_ext[plan.cols_p] & plan.pad_mask).to(torch.int8)
        nxt = csr8.reduce_partials(plan, fe, "LOR", zero) > 0
        frontier = nxt & (lv == 0)
        level += 1
    return lv


def bfs_level(A, start, device=None):
    """Whole-loop level-synchronous BFS (vxm = transposed SpMV); returns
    an INT64 Vector of 1-based levels, present where reached."""
    dev = resolve_device(device)
    if _xspmv_ok(A, types.FP32.MAX_SECOND, np.float32):
        plan = A._xspmv_plan(True, np.float32, device=dev)
        lv = _bfs_one(plan, A.nrows, int(start), dev)
    else:
        lv = _bfs_csr8(A._spmv_plan(True, dev), A.nrows, int(start), dev)
    lv = lv.to(torch.int64)
    return Vector._from_parts(types.INT64, lv, lv > 0)


def bfs_batch(A, sources, device=None):
    """A full BFS from each source in turn (the GAP protocol's source
    trials); returns an int32 (K, n) tensor of 1-based levels (0 =
    unreached), as the JAX package's ``bfs_batch``."""
    dev = resolve_device(device)
    if not _xspmv_ok(A, types.FP32.MAX_SECOND, np.float32):
        return torch.stack([bfs_level(A, int(s), device=dev)._vals
                            .to(torch.int32) for s in np.asarray(sources)])
    plan = A._xspmv_plan(True, np.float32, device=dev)
    return torch.stack([_bfs_one(plan, A.nrows, int(s), dev)
                        for s in np.asarray(sources)])


def _sssp_csr8(A, plan, n, start, dev):
    """Bellman-Ford over a csr8 plan (fused.py:_sssp_loop): MIN_PLUS
    with an infinite fill for float types; for integer types the masked
    SpMV of reached vertices, so that no value stands for infinity.
    Returns (dist, reached)."""
    typ = A.type
    tdt = typ.torch_dtype
    if typ._kind == "f":
        inf = torch.tensor(np.inf, dtype=tdt, device=dev)
        dist = torch.full((n,), np.inf, dtype=tdt, device=dev)
        dist[start] = 0
        changed, i = True, 0
        while changed and i < n:
            relax = _csr8_spmv(plan, dist, lambda a, x: a + x, "MIN", inf,
                               inf)
            new = torch.minimum(dist, relax)
            changed = bool((new < dist).any())
            dist = new
            i += 1
        return dist, torch.isfinite(dist)
    sem = typ.MIN_PLUS
    dist = torch.zeros(n, dtype=tdt, device=dev)
    reached = torch.zeros(n, dtype=torch.bool, device=dev)
    reached[start] = True
    changed, i = True, 0
    while changed and i < n:
        relax, got = csr8.spmv_masked_x(plan, dist, reached, sem,
                                        typ._numpy_t)
        better = got & (~reached | (relax < dist))
        dist = torch.where(better, relax, dist)
        reached = reached | got
        changed = bool(better.any())
        i += 1
    return dist, reached


def sssp(A, start, device=None):
    """Whole-loop Bellman-Ford SSSP (MIN_PLUS); returns a Vector of
    distances, present where reached (fused.py:327-361)."""
    dev = resolve_device(device)
    n = A.nrows
    npdt = A.type.numpy_dtype
    sem = A.type.MIN_PLUS
    if npdt.kind != "f" or not _xspmv_ok(A, sem, npdt):
        dist, reached = _sssp_csr8(A, A._spmv_plan(True, dev), n,
                                   int(start), dev)
        return Vector._from_parts(A.type, dist, reached)
    plan = A._xspmv_plan(True, npdt, device=dev)
    dist = torch.full((n,), np.inf, dtype=A.type.torch_dtype, device=dev)
    dist[int(start)] = 0.0
    changed, i = True, 0
    # cond: changed and i < n -- one scalar a step
    while changed and i < n:
        relax, _ = xs.xspmv(plan, dist, sem, npdt)
        new = torch.minimum(dist, relax)
        changed = bool((new < dist).any())
        dist = new
        i += 1
    return Vector._from_parts(A.type, dist, torch.isfinite(dist))


def bc(A, sources, device=None):
    """Batched Brandes betweenness centrality from `sources`
    (fused.py:370-444): a forward sweep of PLUS_SECOND SpMVs over A^T
    counts shortest paths and records each vertex's level; a backward
    sweep over A accumulates dependencies.  Returns a dense FP32
    Vector."""
    dev = resolve_device(device)
    n = A.nrows
    ns = len(sources)
    sem = types.FP32.PLUS_SECOND
    if not _xspmv_ok(A, sem, np.float32) or A.nrows != A.ncols:
        from . import algorithms

        return algorithms.betweenness_centrality(A, sources, device=dev)
    plan_t = A._xspmv_plan(True, np.float32, device=dev)   # forward
    plan_f = A._xspmv_plan(False, np.float32, device=dev)  # backward

    def spmv_batch(plan, W):
        return torch.stack([xs.xspmv(plan, W[s], sem, np.float32)[0]
                            for s in range(ns)])

    src = torch.as_tensor(np.asarray(sources, np.int64), device=dev)
    paths = torch.zeros((ns, n), dtype=torch.float32, device=dev)
    paths[torch.arange(ns, device=dev), src] = 1.0
    frontier = paths
    level = torch.where(paths > 0, 0, -1).to(torch.int32)  # -1 unreached
    d = 0
    # cond: any(frontier > 0) and d < n -- one scalar a step
    while d < n and bool((frontier > 0).any()):
        nxt = spmv_batch(plan_t, frontier)
        nxt = torch.where(paths > 0, 0.0, nxt.clamp_min(0.0))
        paths = paths + nxt
        level = torch.where(nxt > 0, d + 1, level)
        frontier = nxt
        d += 1
    depth = d
    bcm = torch.ones((ns, n), dtype=torch.float32, device=dev)
    safe_paths = torch.where(paths > 0, paths, 1.0)
    # pairs (level i -> i-1) for i = depth-1 .. 2: the reference sweep
    # never accumulates into the level-0 sources (gap/bcmark.py:52-60)
    for k in range(max(depth - 2, 0)):
        i = depth - 1 - k
        w = torch.where(level == i, bcm / safe_paths, 0.0)
        w2 = spmv_batch(plan_f, w)
        w2 = torch.where(level == i - 1, w2.clamp_min(0.0), 0.0)
        bcm = bcm + w2 * paths
    cent = torch.sum(bcm, dim=0) - np.float32(ns)
    return Vector._from_parts(types.FP32, cent)


# ---------------------------------------------------------------------------
# Device-resident frontier BFS (the push half of direction optimisation)
# ---------------------------------------------------------------------------

def _frontier_csr(A, dev):
    """Dense-indptr CSR over the out-edges on `dev`: indptr int64 (n+1),
    indices int32 (nnz); cached on the matrix per device (resolved, so
    that "cuda" and "cuda:0" share one copy)."""
    dev = resolve_device(dev)
    cache = A._cache()
    key = ("frontier_csr", str(dev))
    if key not in cache:
        u, s, d, outs, _ = A._host_csr(in_is_col=False)
        degs = np.zeros(A.nrows + 1, np.int64)
        degs[u + 1] = d
        cache[key] = (torch.from_numpy(np.cumsum(degs)).to(dev),
                      torch.from_numpy(outs.astype(np.int32)).to(dev))
    return cache[key]


def _frontier_degrees(indptr, fids, fcnt, slot):
    """Per frontier slot: its out-degree (0 past the frontier's `fcnt`
    ids), the inclusive running sum, and each slot's CSR base less its
    run start."""
    act = slot < fcnt
    fi = torch.where(act, fids, 0)
    base = indptr[fi]
    deg = torch.where(act, indptr[fi + 1] - base, 0)
    cum = torch.cumsum(deg, 0)
    return deg, cum, base - (cum - deg)


def _frontier_expand(indices, visited, levels, owner, deg, cum, adj, slot,
                     E, P, n, level):
    """One level's push (fused.py:_bfs_frontier_loop's tier body) in an
    edge buffer of E slots: expand the frontier's edge lists, keep one
    unvisited destination each (the slot whose write to `owner` stuck:
    of duplicate writes one lands, on the card as in XLA), mark and
    level them, and compact them into a frontier buffer of P ids.
    `visited`, `levels` and `owner` are n + 1 long: slot n takes the
    dropped writes.  Returns (new frontier ids, their count as a 0-d
    tensor)."""
    dev = deg.device
    total = cum[-1]
    # slot index of each edge: mark each nonempty run's start with slot
    # + 1, then carry it forward (cummax)
    mk = torch.zeros(E + 1, dtype=torch.int64, device=dev)
    mk.scatter_reduce_(0, torch.where(deg > 0, cum - deg, E), slot + 1,
                       "amax")
    ent = torch.cummax(mk[:E], 0).values - 1
    ar = torch.arange(E, dtype=torch.int64, device=dev)
    valid = ar < total
    off = adj[ent.clamp_min(0)] + ar
    dst = indices[off.clamp(0, indices.shape[0] - 1)].long()
    dstc = torch.where(valid, dst, 0)
    unvis = valid & ~visited[dstc]
    owner.index_put_((torch.where(unvis, dstc, n),), ar)
    win = unvis & (owner[dstc] == ar)
    pos = torch.cumsum(win, 0)
    sel = torch.where(win, dstc, n)
    visited[sel] = True
    levels[sel] = level + 1
    fn = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    fn[torch.where(win & (pos <= P), pos - 1, P)] = dstc
    return fn[:P], pos[-1]


def _bfs_frontier_loop(indptr, indices, n, start, p_bits, e_tiers):
    """The level loop over the frontier as an id buffer of 2**p_bits
    ids: each level expands in the smallest edge tier of `e_tiers` that
    holds its edges.  One host read a level (the new frontier's size
    and its edge total, together) picks the next tier and ends the
    loop.  Returns (int32 levels, overflow, the last level reached):
    overflow when a frontier outgrows the id buffer or its edges every
    tier."""
    dev = indptr.device
    P = 1 << p_bits
    tiers = [1 << eb for eb in e_tiers]
    visited = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    levels = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    owner = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    visited[start] = True
    levels[start] = 1
    slot = torch.arange(P, dtype=torch.int64, device=dev)
    fids = torch.zeros(P, dtype=torch.int64, device=dev)
    fids[0] = start
    fcnt = torch.ones((), dtype=torch.int64, device=dev)
    deg, cum, adj = _frontier_degrees(indptr, fids, fcnt, slot)
    count, total = 1, int(cum[-1])
    level = 1
    while count > 0 and level <= n:
        E = next((t for t in tiers if total <= t), None)
        if E is None:
            return levels[:n], True, level
        fids, fcnt = _frontier_expand(indices, visited, levels, owner, deg,
                                      cum, adj, slot, E, P, n, level)
        deg, cum, adj = _frontier_degrees(indptr, fids, fcnt, slot)
        count, total = torch.stack([fcnt, cum[-1]]).tolist()
        level += 1
        if count > P:
            return levels[:n], True, level
    return levels[:n], False, level - 1


# route of the last bfs_frontier call: "frontier", "retry" (the frontier
# loop with budgets 4x) or "dense" (fused.bfs_level), with its levels
# run and seconds
last_frontier = {}


def bfs_frontier(A, start, p_bits=None, device=None):
    """BFS with O(frontier edges) device work a level: the push half of
    direction optimisation, for high-diameter graphs (road networks)
    where the dense ``bfs_level`` does O(nnz) a level.

    Returns an INT64 Vector of 1-based levels (unreached absent).  A
    budget overflow (giant frontiers: kron graphs) retries once with
    budgets 4x larger, then falls back to the dense ``bfs_level``
    (fused.py:bfs_frontier)."""
    import time

    dev = resolve_device(device)
    n = A.nrows
    if n >= 2**31 or A.nvals >= 2**31 or A.nvals == 0:
        from . import algorithms

        return algorithms.bfs_level(A, start, device=dev)
    t0 = time.perf_counter()
    indptr, indices = _frontier_csr(A, dev)
    nnz_len = int(indices.shape[0])
    if p_bits is None:
        p_bits = max(12, int(np.ceil(np.log2(4.0 * np.sqrt(n)))))
    last_frontier.clear()
    for attempt in ("frontier", "retry"):
        p_bits = min(p_bits, max(int(np.ceil(np.log2(n))), 4))
        e_tiers = tuple(min(eb, max(int(np.ceil(np.log2(nnz_len))), 6))
                        for eb in (p_bits, p_bits + 2, p_bits + 4))
        e_tiers = tuple(dict.fromkeys(e_tiers))  # dedup, keep order
        lv, ovf, ran = _bfs_frontier_loop(indptr, indices, n, int(start),
                                          p_bits, e_tiers)
        last_frontier.update(route=attempt, p_bits=p_bits, levels_run=ran)
        if not ovf:
            break
        p_bits += 2
    else:
        out = bfs_level(A, start, device=dev)
        last_frontier.update(route="dense",
                             seconds=time.perf_counter() - t0)
        return out
    lv = lv.to(torch.int64)
    last_frontier["seconds"] = time.perf_counter() - t0
    return Vector._from_parts(types.INT64, lv, lv > 0)


# ---------------------------------------------------------------------------
# GraphChallenge sparse DNN inference, dense (fused.py:589-650)
# ---------------------------------------------------------------------------

def _dense_f32(mat, dev):
    """A matrix's values as a dense float32 tensor on `dev` (zero where
    absent), scattered from its host COO triples."""
    r, c, v = mat._coo()
    out = torch.zeros((mat.nrows, mat.ncols), dtype=torch.float32,
                      device=dev)
    out[torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)] = \
        torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    return out


def _dnn_loop(wstack, biases, y, clip):
    """y <- min(max(y @ W_l + b_l, 0), clip) over the layers, in full
    float32 (no TF32).  Adding the (negative) bias to absent (zero)
    cells and clamping at 0 reproduces the sparse recurrence exactly:
    the products are nonnegative, so a cell survives iff a product
    exceeded -bias.  Two buffers take turns: no allocation a layer."""
    from .core.dense import _full_fp32

    buf = torch.empty_like(y)
    with _full_fp32():
        for w, b in zip(wstack, biases):
            torch.matmul(y, w, out=buf)
            buf.add_(b).clamp_(0.0, clip)
            y, buf = buf, y
    return y


def dnn(W, B, Y, clip=32.0, device=None):
    """GraphChallenge DNN inference over dense operands: the weights
    stacked (L, n, n) float32 on the device, the images (m, n), one
    matmul a layer with the bias add and the clamp in place on its
    output.  The same result as :func:`algorithms.dnn` for nonnegative
    weights and images (the challenge's domain); returns an FP32
    Matrix, on the bitmap tier where it fits and on the COO tier where
    the containers' options put it (the JAX package's ``_is_huge``)."""
    from .matrix import Matrix

    dev = resolve_device(device)
    n, m = W[0].nrows, Y.nrows
    ws = torch.zeros((len(W), n, n), dtype=torch.float32, device=dev)
    for l, w in enumerate(W):
        r, c, v = w._coo()
        ws[l, torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)] = \
            torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    bv = []    # float32 values, as the JAX package's bias vector holds
    for b in B:
        if not isinstance(b, (int, float)):
            # a bias diagonal (Matrix.identity(..., value=bias))
            dv = b._coo()[2]
            b = dv[0] if len(dv) else 0.0
        bv.append(float(np.float32(b)))
    yv = _dnn_loop(ws, bv, _dense_f32(Y, dev), float(np.float32(clip)))
    del ws
    out = Matrix.sparse(types.FP32, m, n, device=dev)
    if out._is_huge:
        keep = yv != 0
        rr, cc = torch.nonzero(keep, as_tuple=True)
        out._build(rr.cpu().numpy(), cc.cpu().numpy(),
                   yv[rr, cc].cpu().numpy())
    else:
        out._set_dense(yv, yv != 0)
    return out
