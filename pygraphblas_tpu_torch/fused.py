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

Where the JAX package falls back to the csr8 engine or the eager
algorithms (nnz below ``MIN_NNZ``, ``spmv_engine="csr8"``, integer
SSSP, a non-square BC), the port raises ``NotImplementedError``: those
belong to ROADMAP Queue A.
"""

import numpy as np
import torch

from . import types
from ._device import resolve_device
from .base import config
from .core import xspmv as xs
from .vector import Vector

__all__ = ["pagerank", "bfs_level", "bfs_batch", "sssp", "bc"]

_NOT_PORTED = "csr8 engine and eager algorithms: ROADMAP Queue A"


def _xspmv_ok(A, semiring, dtype):
    if config.spmv_engine == "csr8":
        return False
    if config.spmv_engine == "xspmv":
        return True
    return xs.supported(semiring, dtype, A.nvals)


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
    (default: the CUDA card).  Uses the gather-free xspmv engine."""
    dev = resolve_device(device)
    n = A.nrows
    sem = types.FP32.PLUS_SECOND
    if not _xspmv_ok(A, sem, np.float32):
        raise NotImplementedError(_NOT_PORTED)
    plan = A._xspmv_plan(True, np.float32, device=dev)   # y = A^T w
    d_inv = _d_inv(_deg_vec(A, dev), damping)

    def spmv(w):
        return xs.xspmv(plan, w, sem, np.float32)[0]

    r, _, _ = _loop(spmv, n, itermax, d_inv, np.float32((1 - damping) / n),
                    tol)
    return Vector(types.FP32, r)


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


def bfs_level(A, start, device=None):
    """Whole-loop level-synchronous BFS (vxm = transposed SpMV); returns
    an INT64 Vector of 1-based levels, present where reached."""
    dev = resolve_device(device)
    if not _xspmv_ok(A, types.FP32.MAX_SECOND, np.float32):
        raise NotImplementedError(_NOT_PORTED)
    plan = A._xspmv_plan(True, np.float32, device=dev)
    lv = _bfs_one(plan, A.nrows, int(start), dev).to(torch.int64)
    return Vector(types.INT64, lv, lv > 0)


def bfs_batch(A, sources, device=None):
    """A full BFS from each source in turn (the GAP protocol's source
    trials); returns an int32 (K, n) tensor of 1-based levels (0 =
    unreached), as the JAX package's ``bfs_batch``."""
    dev = resolve_device(device)
    if not _xspmv_ok(A, types.FP32.MAX_SECOND, np.float32):
        raise NotImplementedError(_NOT_PORTED)
    plan = A._xspmv_plan(True, np.float32, device=dev)
    return torch.stack([_bfs_one(plan, A.nrows, int(s), dev)
                        for s in np.asarray(sources)])


def sssp(A, start, device=None):
    """Whole-loop Bellman-Ford SSSP (MIN_PLUS, float types); returns a
    Vector of distances, present where finite (fused.py:327-361)."""
    dev = resolve_device(device)
    n = A.nrows
    npdt = A.type.numpy_dtype
    sem = A.type.MIN_PLUS
    if npdt.kind != "f" or not _xspmv_ok(A, sem, npdt):
        raise NotImplementedError(_NOT_PORTED)
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
    return Vector(A.type, dist, torch.isfinite(dist))


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
        raise NotImplementedError(_NOT_PORTED)
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
    return Vector(types.FP32, cent)
