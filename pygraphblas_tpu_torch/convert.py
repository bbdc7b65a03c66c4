"""Plans, containers and algebra objects carried across from the JAX
package.

The JAX plans (``MonoPlan``, ``PermPlan``, ``XSpmvPlan``) are pytrees;
a caller flattens one into a dict of numpy arrays and ints (its leaves
and static fields) and hands the dict here, which builds the port's
plan on a given device.  So both packages can run the very same plan.
This module never sees a JAX object.

A container goes across as the numpy arrays of its ``to_arrays()`` (or
``_coo()``): ``matrix_from_arrays`` and ``vector_from_arrays`` build the
port's Matrix or Vector of the same type, shape and entries.

The algebra goes across by name: ``semiring_from_name``,
``monoid_from_name``, ``binaryop_from_name`` and ``type_from_name`` take
the JAX object's ``.name`` ("PLUS_TIMES_FP32", "MIN_INT8_monoid",
"BSHIFT_UINT16", "UINT32") and return the port's object of that name.

Dict formats (keys as the JAX plans' attributes):
  MonoPlan: S, blk, src_n, src_rows, max_w, stream, xb, xblk_max, ok,
            wva, q0, dm, xblk, qg
  PermPlan: n, trivial, D, S, R0, K, and src_idx (trivial) or
            a_stages (list or (D,R0,128)), c_stages, ssel (or None)
  XSpmvPlan: nrows, ncols, nnz, dtype, n_perm, m1, s1, pre, decode,
            perm (dicts as above), vals_col, levels, places (lists of
            MonoPlan dicts), row_present
"""

import numpy as np

from . import binaryop, monoid, semiring, types
from .matrix import Matrix
from .vector import Vector
from .core.mono import MonoPlan
from .core.perm import PermPlan
from .core.xspmv import XSpmvPlan


def mono_plan_from_arrays(d, device="cpu"):
    s = {k: (bool(d[k]) if k in ("stream", "ok") else int(d[k]))
         for k in MonoPlan.STATIC}
    for k in MonoPlan.ARRAYS:
        s[k] = np.asarray(d[k])
    return MonoPlan.from_state(s, device)


def perm_plan_from_arrays(d, device="cpu"):
    s = {k: (bool(d[k]) if k == "trivial" else int(d[k]))
         for k in PermPlan.STATIC}
    if s["trivial"]:
        s["src_idx"] = np.asarray(d["src_idx"])
    else:
        s["a_stages"] = np.stack([np.asarray(a) for a in d["a_stages"]])
        s["c_stages"] = np.stack([np.asarray(c) for c in d["c_stages"]])
        s["ssel"] = None if d.get("ssel") is None else np.asarray(d["ssel"])
    return PermPlan.from_state(s, device)


def xspmv_plan_from_arrays(d, device="cpu"):
    p = XSpmvPlan()
    for k in ("nrows", "ncols", "nnz", "n_perm", "m1", "s1"):
        setattr(p, k, int(d[k]))
    p.dtype = np.dtype(d["dtype"])
    p.pre = mono_plan_from_arrays(d["pre"])
    p.decode = mono_plan_from_arrays(d["decode"])
    p.perm = perm_plan_from_arrays(d["perm"])
    p.vals_col = np.asarray(d["vals_col"])
    p.levels = [mono_plan_from_arrays(s) for s in d["levels"]]
    p.places = [mono_plan_from_arrays(s) for s in d["places"]]
    p.row_present = np.asarray(d["row_present"])
    return p.to(device)


def semiring_from_name(name):
    """"PLUS_TIMES_FP32" -> the port's ``semiring.PLUS_TIMES_FP32``."""
    return getattr(semiring, name)


def monoid_from_name(name):
    """"MIN_INT8_monoid" -> the port's ``monoid.MIN_INT8_monoid``."""
    return getattr(monoid, name)


def binaryop_from_name(name):
    """"BSHIFT_UINT16" -> the port's ``binaryop.BSHIFT_UINT16``."""
    return getattr(binaryop, name)


def type_from_name(name):
    """"UINT32" -> the port's ``types.UINT32``."""
    return types.MetaType._name_type_map[name]


def matrix_from_arrays(type_name, nrows, ncols, rows, cols, vals,
                       device=None):
    """A Matrix of the type named `type_name` ("FP32", ...) holding the
    entries (rows[k], cols[k]) = vals[k], on `device` (None: the device
    of its first device work)."""
    typ = type_from_name(type_name)
    A = Matrix.sparse(typ, nrows, ncols, device=device)
    A._build(np.asarray(rows, np.int64), np.asarray(cols, np.int64),
             np.asarray(vals).astype(typ._numpy_t))
    return A


def vector_from_arrays(type_name, size, idx, vals, device=None):
    """A Vector of the type named `type_name` holding the entries
    idx[k] = vals[k], on `device` (None: as ``matrix_from_arrays``)."""
    typ = type_from_name(type_name)
    v = Vector.sparse(typ, size, device=device)
    v._build(np.asarray(idx, np.int64), np.asarray(vals).astype(typ._numpy_t))
    return v
