"""Gather-free semiring SpMV: the x-decode / permute / fold pipeline.

Counterpart of ``pygraphblas_tpu/core/xspmv.py``.  Every irregular move
is a monotone windowed gather (core/mono.py), one static Benes
permutation (core/perm.py) or a dense lanewise fold:

  1. decode+mul   xe = mul(vals, x[col]) in column-sorted order
                  (two monotone gathers: ``pre`` then ``decode``).
  2. permute      one static Benes permutation moves products from
                  column order to a slot-major row-grouped layout, with
                  the level-0 8-ary fold fused into its last pass.
  3. fold         log8 levels of slot-major monotone-gather folds.
  4. place        one monotone placement into the dense output vector.

The plan is built on the host with numpy (the same code as the JAX
package, so the same arrays for the same matrix) and then moved to the
device with ``XSpmvPlan.to``.  The fold levels and the placement run as
one ``mono_cascade`` launch where the JAX package's dispatch allows it
(xspmv.py:341-343), else as the per-level chain of ``mono_gather``
launches (xspmv.py:344-348).
"""

import hashlib
import os
import tempfile

import numpy as np
import torch

from .._device import as_tensor
from .mono import MonoPlan, fold_plans, mono_cascade, mono_gather
from .perm import PermPlan, _choose_shape
from .. import types
from ..semiring import FLIPPED, ops_at

# build cost is significant (seconds): only worth it on the hot path
MIN_NNZ = 1 << 15

# plans are pure functions of the matrix structure: cache them on disk
# keyed by content hash, as numpy arrays only (never the JAX package's
# pickles, which live elsewhere)
PLAN_CACHE_DIR = os.environ.get(
    "PYGB_TORCH_PLAN_CACHE",
    os.path.join(tempfile.gettempdir(), "pygb_torch_plans"))
# 2: the placement plan carries the fold cascade's row table
_PLAN_VERSION = 2


# the engine's folds and multiplies (xspmv.py:49-78)
_ADDS = ("PLUS", "MIN", "MAX", "TIMES")
_MULS = ("TIMES", "PLUS", "MINUS", "RMINUS", "DIV", "RDIV", "FIRST",
         "SECOND", "PAIR", "MIN", "MAX")


def supported(semiring, dtype, nnz):
    """The JAX package's rule (xspmv.py:71-78): built-in ops of the
    engine's tables over an int, uint or float dtype, and enough
    entries to pay for the plan."""
    if nnz < MIN_NNZ:
        return False
    add = semiring.add_monoid.binaryop
    mul = semiring.mul_op
    return (add.builtin and mul.builtin and add.op in _ADDS
            and mul.op in _MULS and mul.positional is None
            and np.dtype(dtype).kind in "fiu")


class XSpmvPlan:
    """Static plan for y[r] = fold_c mul(A[r,c], x[c]) on one matrix."""

    STATIC = ("nrows", "ncols", "nnz", "dtype", "n_perm", "m1", "s1")
    __slots__ = STATIC + ("pre", "decode", "perm", "vals_col", "levels",
                          "places", "row_present")

    @staticmethod
    def cache_path(rows, cols, vals, nrows, ncols, dtype):
        """Disk-cache path for this plan (content-hash keyed), or None
        when the matrix is below the caching threshold."""
        if len(rows) < (1 << 20):
            return None
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(rows, np.int64).tobytes())
        h.update(np.ascontiguousarray(cols, np.int64).tobytes())
        h.update(np.ascontiguousarray(vals).tobytes())
        h.update(f"{nrows}|{ncols}|{np.dtype(dtype).str}|"
                 f"torch{_PLAN_VERSION}".encode())
        return os.path.join(PLAN_CACHE_DIR, h.hexdigest() + ".npz")

    @staticmethod
    def build(rows, cols, vals, nrows, ncols, dtype, cache=True):
        """rows/cols/vals: canonical COO (any order), numpy arrays.
        Returns a host (numpy) plan; move it with ``to(device)``."""
        key = None
        if cache:
            key = XSpmvPlan.cache_path(rows, cols, vals, nrows, ncols,
                                       dtype)
        if key is not None and os.path.exists(key):
            with np.load(key) as z:
                return XSpmvPlan.from_state(_unflatten(z))
        p = XSpmvPlan._build(rows, cols, vals, nrows, ncols, dtype)
        if key is not None:
            os.makedirs(PLAN_CACHE_DIR, exist_ok=True)
            tmp = key + f".tmp{os.getpid()}.npz"
            np.savez(tmp, **_flatten(p.state()))
            os.replace(tmp, key)
        return p

    @staticmethod
    def _build(rows, cols, vals, nrows, ncols, dtype):
        p = XSpmvPlan()
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        nnz = len(rows)
        dtype = np.dtype(dtype)
        p.nrows, p.ncols, p.nnz, p.dtype = nrows, ncols, nnz, dtype

        # --- column order: decode plan + values ---------------------------
        # two-stage decode: compact x to the present column ids first,
        # then gather products in rank space
        corder = np.lexsort((rows, cols))
        colv = cols[corder]
        newc = np.empty(nnz, bool)
        if nnz:
            newc[0] = True
            np.not_equal(colv[1:], colv[:-1], out=newc[1:])
        uniq = colv[newc]
        rank = np.cumsum(newc, dtype=np.int32) - 1
        p.pre = MonoPlan.build(uniq, ncols, dtype.itemsize)
        p.decode = MonoPlan.build(rank, len(uniq), dtype.itemsize)
        vc = np.zeros(p.decode.S * 128, dtype)
        vc[:nnz] = np.asarray(vals, dtype)[corder]
        p.vals_col = vc
        p.s1 = p.decode.S

        # --- row order: degrees, group offsets, slot-major dst ------------
        rorder = np.lexsort((cols, rows))
        rsorted = rows[rorder]
        newr = np.empty(nnz, bool)
        if nnz:
            newr[0] = True
            np.not_equal(rsorted[1:], rsorted[:-1], out=newr[1:])
        starts = np.flatnonzero(newr)
        urows = rsorted[starts]
        degs = np.diff(np.append(starts, nnz))
        g_r = -(-degs // 8)                       # level-1 groups per row
        gof = np.zeros(len(urows), np.int64)
        gof[1:] = np.cumsum(g_r)[:-1]
        m1 = int(g_r.sum()) if len(g_r) else 1
        m1p = -(-m1 // 128) * 128
        p.m1 = m1p
        # bijection space: covers both the slot-major dst (8*m1p) and the
        # row-padded decode output (S1*128)
        n_perm = max(8 * m1p, p.decode.S * 128)
        # pad up to the next S*128^D boundary when the overhead is small:
        # a K == 128 permutation is what the fused middle and the
        # fold8-fused ascend need (kron-20 sits just under a boundary:
        # K would be 127 without this pad)
        _, _, r0 = _choose_shape(n_perm, 128)
        if -(-n_perm // r0) >= 112:
            n_perm = r0 * 128
        p.n_perm = n_perm

        # dst position of edge: k-th edge of row r, in blocks of
        # (8 slots x 128 groups) so the level-0 fold runs over rows
        k_within = (np.arange(nnz, dtype=np.int32)
                    - np.repeat(starts, degs).astype(np.int32))
        grp = np.repeat(gof, degs).astype(np.int32) + k_within // 8
        slot = k_within % 8
        dstpos = (grp // 128) * 1024 + slot * 128 + (grp % 128)
        inv_corder = np.empty(nnz, np.int32)
        inv_corder[corder] = np.arange(nnz, dtype=np.int32)
        srcpos = inv_corder[rorder]
        # complete to a bijection on n_perm: pads <-> pads
        src_of_dst = np.full(n_perm, -1, np.int64)
        src_of_dst[dstpos] = srcpos
        free_dst = np.flatnonzero(src_of_dst < 0)
        free_src = np.arange(nnz, n_perm, dtype=np.int64)
        src_of_dst[free_dst] = free_src
        p.perm = PermPlan.build(src_of_dst)

        # --- reduction levels + single final placement --------------------
        # level k folds each row's c_k cells to c_{k+1} = ceil(c_k/8);
        # reduced rows ride along as single-child groups; present row r's
        # value is placed at output urows[r]
        p.levels, place = fold_plans(g_r, nrows, urows, dtype.itemsize)
        p.places = [place]
        rp = np.zeros(nrows, bool)
        rp[rows] = True
        p.row_present = rp
        return p

    # -- state / device ------------------------------------------------------

    def state(self):
        d = {k: getattr(self, k) for k in self.STATIC}
        d["dtype"] = np.dtype(self.dtype).str
        d["pre"] = self.pre.state()
        d["decode"] = self.decode.state()
        d["perm"] = self.perm.state()
        d["vals_col"] = np.asarray(self.vals_col)
        d["levels"] = [lp.state() for lp in self.levels]
        d["places"] = [pp.state() for pp in self.places]
        d["row_present"] = np.asarray(self.row_present)
        return d

    @staticmethod
    def from_state(d, device=None):
        p = XSpmvPlan()
        for k in XSpmvPlan.STATIC:
            setattr(p, k, d[k])
        p.dtype = np.dtype(d["dtype"])
        p.pre = MonoPlan.from_state(d["pre"])
        p.decode = MonoPlan.from_state(d["decode"])
        p.perm = PermPlan.from_state(d["perm"])
        p.vals_col = np.asarray(d["vals_col"])
        p.levels = [MonoPlan.from_state(s) for s in d["levels"]]
        p.places = [MonoPlan.from_state(s) for s in d["places"]]
        p.row_present = np.asarray(d["row_present"])
        return p.to(device) if device is not None else p

    def to(self, device):
        p = XSpmvPlan()
        for k in self.STATIC:
            setattr(p, k, getattr(self, k))
        p.pre = self.pre.to(device)
        p.decode = self.decode.to(device)
        p.perm = self.perm.to(device)
        p.vals_col = as_tensor(self.vals_col, device)
        p.levels = [lp.to(device) for lp in self.levels]
        p.places = [pp.to(device) for pp in self.places]
        p.row_present = as_tensor(self.row_present, device)
        return p


def _flatten(state, prefix=""):
    """Nested plan state -> flat {path: array} for np.savez."""
    out = {}
    for k, v in state.items():
        key = prefix + k
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, list):
            out[key + ".len"] = np.asarray(len(v))
            for i, s in enumerate(v):
                out.update(_flatten(s, f"{key}.{i}."))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(z):
    """Inverse of _flatten over an np.load mapping."""
    flat = {k: z[k] for k in z.files}

    def build(prefix):
        d = {}
        names = {k[len(prefix):].split(".")[0] for k in flat
                 if k.startswith(prefix)}
        for name in names:
            key = prefix + name
            if key + ".len" in flat:
                d[name] = [build(f"{key}.{i}.")
                           for i in range(int(flat[key + ".len"]))]
            elif key in flat:
                a = flat[key]
                d[name] = a.item() if a.ndim == 0 else a
            else:
                d[name] = build(key + ".")
        return d

    return build("")


def xspmv(plan, x, semiring, out_dtype, flip_mul=False):
    """Execute y = A (add.mul) x with dense x; returns (y, present_mask).

    flip_mul: the multiply's operand roles are (x, A) instead of (A, x)
    -- required by vxm with non-commutative muls."""
    out_dtype = np.dtype(out_dtype)
    typ = types._gb_from_dtype(out_dtype)
    tdt = typ.torch_dtype
    addop, mulop = ops_at(semiring, typ)
    fill = typ.scalar(addop.identity(out_dtype))

    xx = x.to(tdt)
    # effective mul under flipped operand roles: vxm passes
    # flip_mul=True, where FIRST selects the vector element; integer DIV
    # truncates with the SuiteSparse zero rule (the JAX package's xspmv
    # divides truly here: ROADMAP.md Queue C)
    mul_name = mulop.op
    if flip_mul:
        mul_name = FLIPPED.get(mul_name, mul_name)
        mulop = getattr(typ, mul_name)
    vals_col = plan.vals_col.to(tdt)
    if mul_name == "FIRST" and addop.op == "PLUS":
        # product = matrix value: the column-order values ARE the
        # products (PLUS only: vals_col pads are zeros = the identity)
        prod = vals_col
    elif mul_name == "SECOND":
        # product = x value: skip the matrix-values read entirely
        xc = mono_gather(plan.pre, xx, fill)
        prod = mono_gather(plan.decode, xc.reshape(-1), fill)
    else:
        xc = mono_gather(plan.pre, xx, fill)
        prod = mono_gather(plan.decode, xc.reshape(-1), fill,
                           vals=vals_col, mul=mulop)
    # the permutation pads the tail with the fold identity; the level-0
    # 8-ary fold is fused into its final ascend pass
    acc1, _ = plan.perm.apply_fold8(prod.reshape(-1), fill, addop)
    cur = acc1.reshape(-1)[:plan.m1]
    # all fold levels + the final placement in one launch; None -> the
    # per-level chain (a streamed or per-row plan, or no levels)
    y2d = mono_cascade(plan.levels, plan.places[0], cur, fill, addop)
    if y2d is not None:
        return y2d.reshape(-1)[:plan.nrows], plan.row_present
    for lp in plan.levels:
        cur = mono_gather(lp, cur.reshape(-1), fill,
                          fold=addop).reshape(-1)
    # single final placement: every present row holds one cell in row
    # order after the last level; absent rows read the -1 pad -> fill
    y = mono_gather(plan.places[0], cur.reshape(-1), fill)
    y = y.reshape(-1)[:plan.nrows]
    return y, plan.row_present
