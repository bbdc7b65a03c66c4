"""Whole-loop PageRank over the xspmv engine.

Counterpart of ``pygraphblas_tpu/fused.py`` (``pagerank``,
``_pagerank_loop_coo``, ``_deg_vec``).  The JAX package compiles the
loop into one XLA program; here it is a Python loop of kernel launches
on one CUDA stream.  With ``tol < 0`` the loop reads nothing back to the
host (it runs exactly ``itermax`` iterations); with ``tol >= 0`` it
reads the one scalar ``rdiff`` per iteration for the stopping test.
"""

import numpy as np
import torch

from . import types
from ._device import resolve_device
from .base import config
from .core import xspmv as xs
from .vector import Vector

__all__ = ["pagerank"]


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
        raise NotImplementedError("csr8 engine: ROADMAP Queue A")
    plan = A._xspmv_plan(True, np.float32, device=dev)   # y = A^T w
    d_inv = _d_inv(_deg_vec(A, dev), damping)

    def spmv(w):
        return xs.xspmv(plan, w, sem, np.float32)[0]

    r, _, _ = _loop(spmv, n, itermax, d_inv, np.float32((1 - damping) / n),
                    tol)
    return Vector(types.FP32, r)
