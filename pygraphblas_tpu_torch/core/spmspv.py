"""SpMSpV: semiring matrix-vector product with a SPARSE vector.

Counterpart of ``pygraphblas_tpu/core/spmspv.py``: for a frontier x
given as (index, value) packets only the matrix rows the frontier
touches are read, so a call costs O(frontier edges), not O(n) or
O(nnz).  Sorted search of the frontier ids against the matrix's in-id
CSR segments and the expansion of the touched edge ranges run on the
host (numpy, as in the JAX package), and so do the multiplies numpy
has; the positional and the other multiplies and the compact segment
reduce by out-id run on `device` (``sparse.coo_segment_reduce_compact``).
"""

import numpy as np
import torch

from .. import types
from ..binaryop import at_type, np_binop
from .spgemm import _row_lookup
from .sparse import coo_segment_reduce_compact, segment_fold_generic

_NP_MUL = {
    "TIMES": np.multiply,
    "PLUS": np.add,
    "MINUS": np.subtract,
    "MIN": np.minimum,
    "MAX": np.maximum,
    "DIV": np.divide,
    "FIRST": lambda a, x: a,
    "SECOND": lambda a, x: x,
    "PAIR": lambda a, x: np.ones_like(a),
    "LAND": lambda a, x: a.astype(bool) & x.astype(bool),
    "LOR": lambda a, x: a.astype(bool) | x.astype(bool),
}


def expand_segments(starts, degs):
    """Concatenated ranges [starts_i, starts_i+degs_i) plus the source
    entry index of each expanded element."""
    total = int(degs.sum())
    ent = np.repeat(np.arange(len(degs)), degs)
    if total == 0:
        return ent, np.empty(0, np.int64)
    base = np.repeat(starts, degs)
    run0 = np.repeat(np.cumsum(degs) - degs, degs)
    return ent, base + (np.arange(total) - run0)


def spmspv(u, s, d, in_sorted_out_ids, in_sorted_vals, fi, fx,
           semiring, out_dtype, flip_mul=False, *, device):
    """y = A (+.x) x over the frontier (fi, fx).

    (u, s, d): unique in-ids / segment starts / degrees of the matrix
    sorted by in-id; in_sorted_out_ids/vals: the out-id and value of
    each edge in that order.  Returns host (unique out ids, values)."""
    out_dtype = np.dtype(out_dtype)
    st, dg = _row_lookup(u, s, d, fi)
    ent, offs = expand_segments(st, dg)
    if len(offs) == 0:
        return np.empty(0, np.int64), np.empty(0, out_dtype)
    out_ids = in_sorted_out_ids[offs]
    av = in_sorted_vals[offs]
    xv = fx[ent]
    mul = semiring.mul_op
    add_bin = semiring.add_monoid.binaryop
    is_struct = av.dtype.names is not None or xv.dtype.names is not None
    np_mul = _NP_MUL.get(mul.op) if (mul.builtin
                                     and mul.positional is None) else None
    if is_struct or not (add_bin.builtin and add_bin.op in (
            "PLUS", "MIN", "MAX", "TIMES", "LOR", "LAND", "LXOR", "ANY")):
        # struct UDTs / user monoids: the op's own multiply and the
        # identity-free host segment fold
        a1, a2 = (xv, av) if flip_mul else (av, xv)
        prod = np.asarray(np_binop(mul)(a1, a2))
        order = np.argsort(out_ids, kind="stable")
        return segment_fold_generic(out_ids[order], prod[order],
                                    np_binop(add_bin))
    typ = types._gb_from_dtype(out_dtype)
    if np_mul is not None:
        a1, a2 = (xv, av) if flip_mul else (av, xv)
        if out_dtype == np.bool_:
            prod = np_mul(a1.astype(bool), a2.astype(bool))\
                .astype(out_dtype)
        else:
            with np.errstate(all="ignore"):
                prod = np_mul(a1.astype(out_dtype),
                              a2.astype(out_dtype)).astype(out_dtype)
    elif mul.positional is not None:
        # same operand-role convention as core/sparse.py coo_spmv
        in_ids = torch.as_tensor(fi[ent], device=device)
        oi = torch.as_tensor(out_ids, device=device)
        z = torch.zeros(len(in_ids), dtype=torch.int64, device=device)
        if flip_mul:   # vxm: first = x' (row vector), second = A
            pos = dict(i0=z, j0=in_ids, i1=in_ids, j1=oi)
        else:          # mxv: first = A, second = x
            pos = dict(i0=oi, j0=in_ids, i1=in_ids, j1=z)
        prod = torch.broadcast_to(mul.apply(None, None, pos),
                                  oi.shape).to(typ.torch_dtype).contiguous()
    else:
        a1, a2 = (xv, av) if flip_mul else (av, xv)
        f = at_type(mul, typ)
        prod = f.apply(typ.to_torch(a1, device), typ.to_torch(a2, device))\
            .to(typ.torch_dtype)
    return coo_segment_reduce_compact(out_ids, prod, semiring.add_monoid,
                                      out_dtype, device)
