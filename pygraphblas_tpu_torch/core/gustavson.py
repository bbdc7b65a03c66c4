"""Unmasked sparse SpGEMM: C = A (+.x) B on canonical COO triples.

Counterpart of ``pygraphblas_tpu/core/gustavson.py``, with its tiers in
its order (``spgemm``, gustavson.py:187-316):

1. the diagonal-B fast path: C = A scaled column by column, O(nnz);
2. the compact-dense tier (``dense_spgemm``): the present rows, inner
   and columns relabelled and densified, one matmul (core/dense.py)
   within ``config.spgemm_dense_cells`` cells;
3. on the card, the expand/sort/compact engine (core/esc.py), with its
   two kernels (``segfold``, ``esc_gather``);
4. the host scipy tier for the PLUS_{TIMES,FIRST,SECOND,PAIR} family,
   with the pruned exact zeros re-filled against the symbolic pattern;
5. the generic tier: the symbolic pattern (scipy) as the structural mask
   of the masked SpGEMM (core/spgemm.py), which runs on the device.

``config.spgemm_engine`` ("auto" | "dense" | "esc" | "scipy") picks as
in the JAX package, with "the device is ``cuda``" where the JAX code
asks for a TPU.  Host arrays are numpy; the device work runs on
`device` (default ``cuda``; ``device="cpu"`` runs the plain versions).
"""

import numpy as np
import torch

from .. import types
from .._device import as_tensor, resolve_device
from ..base import config
from ..semiring import ops_at
from . import coosem as cs
from .spgemm import _pull


def _pow2(x, lo=8):
    p = lo
    while p < x:
        p *= 2
    return p


def _dense_ok(semiring, out_dtype, kc, device):
    """Algebras the dense tier may use (gustavson.py:44-61): those
    core/dense.py lowers to one matmul; the generic broadcast-reduce is
    never a win over the sparse tiers, so it is not taken here."""
    from .dense import _matmul_ok

    add = semiring.add_monoid.binaryop
    mul = semiring.mul_op
    if not (add.builtin and mul.builtin) or mul.positional is not None:
        return False
    out_dtype = np.dtype(out_dtype)
    if add.op == "PLUS" and mul.op == "PAIR" and out_dtype != np.bool_:
        return device.type != "cuda" or kc <= (1 << 24)
    if add.op == "PLUS" and mul.op == "TIMES" and out_dtype != np.bool_:
        return _matmul_ok(out_dtype, device)
    if (add.op in ("LOR", "ANY")
            and mul.op in ("LAND", "PAIR", "FIRST", "SECOND", "TIMES")
            and out_dtype == np.bool_):
        return True
    return False


def _sample_distinct_lb(arr, k=4096):
    """Cheap LOWER bound on the number of distinct values: distinct
    count of a k-element stride sample (never overestimates)."""
    if len(arr) <= k:
        return len(np.unique(arr))
    return len(np.unique(arr[:: max(1, len(arr) // k)][:k]))


def _densify(ri, ci, v, m, k):
    """(m, k) values and bool pattern with v at (ri, ci)."""
    vals = torch.zeros((m, k), dtype=v.dtype, device=v.device)
    vals[ri, ci] = v
    mask = torch.zeros((m, k), dtype=torch.bool, device=v.device)
    mask[ri, ci] = True
    return vals, mask


def _pack_mask(tm):
    """Flat positions of the pattern's entries, on the device (the JAX
    package packs a bitmap for the TPU's transfer: the same positions)."""
    return torch.nonzero(tm.reshape(-1)).squeeze(1)


def dense_spgemm(ra, ca, va, rb, cb, vb, semiring, out_dtype, device=None):
    """Compact-densify tier: relabel the present rows, inner and columns,
    scatter both operands into dense (Mc,Kc) and (Kc,Nc) arrays on the
    device and multiply once (core/dense.py).  Returns canonical COO, or
    None when the product does not fit the cell budget or the algebra
    has no matmul."""
    from . import dense as dk

    dev = resolve_device(device)
    out_dtype = np.dtype(out_dtype)
    # cheap pre-reject before the O(nnz log nnz) relabel: sampled lower
    # bounds on the compact dims
    budget = config.spgemm_dense_cells
    mc_lb = _pow2(_sample_distinct_lb(ra))
    kc_lb = _pow2(max(_sample_distinct_lb(ca), _sample_distinct_lb(rb)))
    nc_lb = _pow2(_sample_distinct_lb(cb))
    if mc_lb * kc_lb > budget or kc_lb * nc_lb > budget \
            or mc_lb * nc_lb > budget:
        return None
    (ur, ri), (uk, ka, kb), (uc, ci) = _relabel(ra, ca, rb, cb)
    mc = _pow2(len(ur))
    kc = _pow2(len(uk))
    nc = _pow2(len(uc))
    if mc * kc > budget or kc * nc > budget or mc * nc > budget \
            or not _dense_ok(semiring, out_dtype, kc, dev):
        return None

    typ = types._gb_from_dtype(out_dtype)

    def scatter(m, k, rr, cc, vv):
        return _densify(as_tensor(np.asarray(rr, np.int64), dev),
                        as_tensor(np.asarray(cc, np.int64), dev),
                        typ.to_torch(vv, dev), m, k)

    av, am = scatter(mc, kc, ri, ka, va)
    bv, bm = scatter(kc, nc, kb, ci, vb)
    tv, tm = dk.mxm(av, am, bv, bm, semiring, out_dtype)
    pos_d = _pack_mask(tm)
    pos, vals = _pull([pos_d, tv.reshape(-1)[pos_d]])
    if len(pos) == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, out_dtype)
    rr, cc = pos // nc, pos % nc
    return ur[rr], uc[cc], vals.view(out_dtype)


def _relabel(ra, ca, rb, cb):
    """Compact the row/k/col index spaces; k is shared by A-cols and
    B-rows."""
    ur, ri = np.unique(ra, return_inverse=True)
    uk, ki = np.unique(np.concatenate([ca, rb]), return_inverse=True)
    uc, ci = np.unique(cb, return_inverse=True)
    return (ur, ri), (uk, ki[:len(ca)], ki[len(ca):]), (uc, ci)


def pattern(ra, ca, rb, cb):
    """Structural product pattern of A @ B: canonical (rows, cols) in the
    original index space."""
    from scipy import sparse

    if len(ra) == 0 or len(rb) == 0:
        e = np.empty(0, np.int64)
        return e, e.copy()
    (ur, ri), (uk, ka, kb), (uc, ci) = _relabel(ra, ca, rb, cb)
    A = sparse.csr_matrix((np.ones(len(ra), np.int64), (ri, ka)),
                          shape=(len(ur), len(uk)))
    B = sparse.csr_matrix((np.ones(len(rb), np.int64), (kb, ci)),
                          shape=(len(uk), len(uc)))
    P = A @ B
    P.sort_indices()
    P = P.tocoo()
    return ur[P.row], uc[P.col]


_SCIPY_MULS = ("TIMES", "FIRST", "SECOND", "PAIR")

def spgemm(ra, ca, va, rb, cb, vb, semiring, out_dtype, dims=None,
           device=None):
    """C = A (+.x) B, unmasked, canonical COO in, canonical COO out.

    Engine dispatch (``options_set(spgemm_engine=...)``): "auto" tries
    the compact-dense tier, then on the card the expand/sort/compact
    engine (core/esc.py), then the host tiers; "dense", "esc" and
    "scipy" force a tier.  `dims` = (nrows_a, inner, ncols_b) logical
    dims when known: small dims skip the index-compaction relabel of the
    host tiers.  Device work runs on `device` (default ``cuda``)."""
    from scipy import sparse

    dev = resolve_device(device)
    out_dtype = np.dtype(out_dtype)
    if len(ra) == 0 or len(rb) == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, out_dtype)

    engine = config.spgemm_engine

    # diagonal-B fast path: C = A with values mul(a_ij, d_j) on the
    # columns where the diagonal is present (it overrides the engine),
    # the multiply at the output type
    if not semiring.mul_op.positional and bool(np.all(rb == cb)):
        typ = types._gb_from_dtype(out_dtype)
        _, mul = ops_at(semiring, typ)
        pos = np.searchsorted(rb, ca)
        pos_c = np.minimum(pos, len(rb) - 1)
        hit = rb[pos_c] == ca
        vals = typ.to_numpy(mul.apply(typ.to_torch(va[hit]),
                                      typ.to_torch(vb[pos_c[hit]])))
        return ra[hit], ca[hit], vals.astype(out_dtype)

    if engine in ("auto", "dense"):
        res = dense_spgemm(ra, ca, va, rb, cb, vb, semiring, out_dtype,
                           device=dev)
        if res is not None:
            return res
    if engine == "esc" or (engine == "auto" and dev.type == "cuda"):
        from .esc import esc_spgemm

        res = esc_spgemm(ra, ca, va, rb, cb, vb, semiring, out_dtype,
                         device=dev)
        if res is not None:
            return res

    add, mul = semiring.add_monoid.binaryop, semiring.mul_op
    plus_family = (add.builtin and add.op == "PLUS" and mul.builtin
                   and mul.positional is None and mul.op in _SCIPY_MULS
                   and out_dtype.kind in "fiu")
    mul = mul.op

    # identity "relabel" pays an O(dim) scipy indptr per operand, so it
    # needs dims both int32-safe AND comparable to nnz (hypersparse
    # 2^60-dim matrices still relabel)
    nnz_ab = len(ra) + len(rb)
    if dims is not None and max(dims) < (1 << 31) \
            and max(dims) <= max(1 << 22, 8 * nnz_ab):
        ur = uk = uc = None
        ri, ka, kb, ci = ra, ca, rb, cb
        sm, sk, sn = dims
    else:
        (ur, ri), (uk, ka, kb), (uc, ci) = _relabel(ra, ca, rb, cb)
        sm, sk, sn = len(ur), len(uk), len(uc)
    Ac = sparse.csr_matrix((np.ones(len(ra), np.int64), (ri, ka)),
                           shape=(sm, sk))
    Bc = sparse.csr_matrix((np.ones(len(rb), np.int64), (kb, ci)),
                           shape=(sk, sn))
    P = Ac @ Bc
    P.sort_indices()
    P = P.tocoo()
    pr, pc = P.row.astype(np.int64), P.col.astype(np.int64)

    if plus_family:
        # numeric via scipy; accumulate in f64 (or i64) for accuracy
        acc_dt = np.float64 if out_dtype.kind == "f" else np.int64
        av = (np.ones(len(ra), acc_dt) if mul in ("SECOND", "PAIR")
              else va.astype(acc_dt))
        bv = (np.ones(len(rb), acc_dt) if mul in ("FIRST", "PAIR")
              else vb.astype(acc_dt))
        if mul == "PAIR":
            vals = P.data.astype(out_dtype)  # the counts themselves
        else:
            An = sparse.csr_matrix((av, (ri, ka)), shape=(sm, sk))
            Bn = sparse.csr_matrix((bv, (kb, ci)), shape=(sk, sn))
            Q = An @ Bn
            Q.sort_indices()
            Q = Q.tocoo()
            # scipy prunes exact-zero results; re-fill them as stored
            # zeros against the symbolic pattern
            vals = np.zeros(len(pr), out_dtype)
            if Q.nnz:
                hit = cs.in_sorted(pr, pc, Q.row.astype(np.int64),
                                   Q.col.astype(np.int64))
                vals[hit] = Q.data.astype(out_dtype)
        if ur is None:
            return pr, pc, vals
        return ur[pr], uc[pc], vals

    # general semiring: numeric fill = masked SpGEMM with the symbolic
    # pattern as a structural mask (the device intersect kernels)
    from .coosparse import build
    from .spgemm import masked_spgemm

    out_r, out_c = (pr, pc) if ur is None else (ur[pr], uc[pc])
    bt_r, bt_c, bt_v = build(cb, rb, vb, vb.dtype)   # B transposed
    # every entry of the structural pattern has a nonempty intersection
    return masked_spgemm(ra, ca, va, bt_r, bt_c, bt_v, out_r, out_c,
                         semiring, out_dtype, device=dev)
