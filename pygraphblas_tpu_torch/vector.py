"""The GraphBLAS Vector container.

Counterpart of ``pygraphblas_tpu/vector.py``, the 1-D twin of
:class:`~.matrix.Matrix`.  A vector lives in one of three formats:

- **bitmap**: a (vals, mask) pair of tensors on one device whenever the
  size fits ``vector_max_cells``; every operation is plain torch over
  them (``core/dense.py``).  Until its first device work a bitmap vector
  holds its contents as canonical host (index, value) arrays and no
  tensor, so building one needs no device.
- **coo**: host sorted (index, value) arrays for huge logical sizes (up
  to ``GxB_INDEX_MAX``).
- **iso**: one repeated value past the dense budget, O(1).

Every constructor takes ``device=``; a vector built without one takes
the device of the first operation that needs one (the card, raising
when there is none, unless an operand names another).  Operations run
on their operands' device and raise if the operands sit on different
devices.  Values are held in their type's held dtype (``types.py``:
UINT16/32/64 as signed bit views).
"""

import operator
import random as _stdlib_random
import types as _pytypes
from array import array
from functools import partial

import numpy as np
import torch

from .base import (
    _timed,
    GxB_INDEX_MAX,
    NoValue,
    DimensionMismatch,
    InsufficientSpace,
    InvalidValue,
    InvalidIndex,
    _build_range,
    _get_bin_op,
    _get_select_op,
    config,
)
from . import types
from .types import promote, _gb_from_type, _type_from_value
from .binaryop import at_type, current_accum, current_binop, np_binop
from .unaryop import at_type as unary_at_type
from .monoid import Monoid, current_monoid
from .semiring import Semiring, current_semiring
from .selectop import SelectOp, DEFAULT_THUNKS
from .descriptor import Default, current_desc
from .scalar import Scalar
from ._device import common_device, resolve_device
from .core import dense as dk
from .core import coosparse as ck

__all__ = ["Vector"]


def _is_scalar(x):
    return isinstance(x, (bool, int, float, complex, np.generic))


def _is_int(x):
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _check_indices(idx, size):
    """Build indices: past the size is the JAX package's
    DimensionMismatch; a negative one raises IndexError."""
    if len(idx) and idx.max() >= size:
        raise DimensionMismatch("index out of bounds in build")
    if len(idx) and idx.min() < 0:
        raise IndexError("negative index in build")


class Vector:
    """GraphBLAS Vector.

    >>> v = Vector.from_lists([0, 1, 2], [1, 2, 3])
    >>> print(v)
    0| 1
    1| 2
    2| 3
    """

    __slots__ = (
        "type",
        "_size",
        "_fmt",
        "_vals",        # bitmap: tensor (size,), or None while staged
        "_mask",
        "_idx_h",       # coo, and a staged bitmap: np.int64 sorted
        "_vals_h",
        "_iso_v",       # iso format: the single repeated value
        "_pending",
        "_nvals_c",
        "_host_c",
        "_hyper_switch",
        "_sparsity",
        "_dev",         # torch.device, or None until the first device work
    )

    def __init__(self, typ, size, fmt=None, device=None):
        self.type = typ
        self._size = int(size)
        self._pending = []
        self._nvals_c = None
        self._host_c = None
        self._iso_v = None
        self._hyper_switch = config.hyper_switch
        self._sparsity = 15  # GxB_AUTO_SPARSITY
        self._dev = None if device is None else resolve_device(device)
        if fmt is None:
            fmt = "bitmap" if self._fits_bitmap(size, typ) else "coo"
        self._fmt = fmt
        self._vals = self._mask = None
        if fmt == "iso":
            self._idx_h = self._vals_h = None
        else:
            self._idx_h = np.empty(0, np.int64)
            self._vals_h = np.empty(0, typ._numpy_t)

    @staticmethod
    def _fits_bitmap(size, typ=None):
        if typ is not None and not typ._allows_bitmap:
            return False
        return size <= config.vector_max_cells

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def sparse(cls, typ, size=None, fill=None, mask=None, device=None):
        """An empty sparse Vector (unbounded size defaults to
        GxB_INDEX_MAX).

        >>> v = Vector.sparse(types.INT64, 3)
        >>> v.size
        3
        """
        if size is None:
            size = GxB_INDEX_MAX
        v = cls(typ, size, device=device)
        if fill is not None and mask is not None:
            v.assign_scalar(fill, mask=mask)
        return v

    @classmethod
    def dense(cls, typ, size=None, fill=None, device=None):
        """A dense Vector: all elements present.

        >>> print(Vector.dense(types.INT64, 3, fill=7))
        0| 7
        1| 7
        2| 7
        >>> print(Vector.dense(types.FP32, 3, fill=1.5))
        0|1.5
        1|1.5
        2|1.5
        """
        if size is None:
            size = GxB_INDEX_MAX
        fillv = typ.default_zero if fill is None else fill
        if not cls._fits_bitmap(size, typ):
            if size > (1 << 27) or not typ._allows_bitmap:
                raise InsufficientSpace(
                    "dense vector too large (use Vector.iso for O(1) "
                    "all-same-value vectors)")
            v = cls(typ, size, fmt="coo", device=device)
            v._set_coo(np.arange(size, dtype=np.int64),
                       np.full(size, typ._coerce(fillv), typ._numpy_t))
            return v
        v = cls(typ, size, fmt="bitmap", device=device)
        dev = v._device()
        v._set_dense(torch.full((v._size,), typ.scalar(typ._coerce(fillv)),
                                dtype=typ.torch_dtype, device=dev),
                     torch.ones(v._size, dtype=torch.bool, device=dev))
        return v

    @classmethod
    def iso(cls, value, size=GxB_INDEX_MAX, device=None):
        """Dense Vector of one repeated value; type inferred.  Sizes past
        the dense budget store the value once (O(1)).

        >>> print(Vector.iso(3, 2))
        0| 3
        1| 3
        """
        typ = _type_from_value(value)
        if not cls._fits_bitmap(size, typ):
            v = cls(typ, size, fmt="iso", device=device)
            v._iso_v = typ._coerce(value)
            return v
        return cls.dense(typ, size, fill=value, device=device)

    @classmethod
    def from_lists(cls, I, V=None, size=None, typ=None, device=None):
        """From index and value lists.

        >>> print(Vector.from_lists([0, 2], [1, 2]))
        0| 1
        1|
        2| 2
        """
        if V is None:
            V = [True] * len(I)
            typ = types.BOOL if typ is None else typ
        if len(I) != len(V):
            raise InvalidValue("index and value lists must be the same length")
        if size is None:
            size = max(I) + 1
        if typ is None:
            typ = _type_from_value(V[0])
        v = cls.sparse(typ, size, device=device)
        v._build(np.asarray(I), np.asarray(V))
        return v

    @classmethod
    def from_list(cls, I, device=None):
        """A dense vector from a list of values.

        >>> print(Vector.from_list([1, 2, 3]))
        0| 1
        1| 2
        2| 3
        """
        size = len(I)
        if size == 0:
            raise InvalidValue("from_list needs at least one value")
        typ = _gb_from_type(type(I[0]))
        v = cls.sparse(typ, size, device=device)
        v._build(np.arange(size, dtype=np.int64), np.asarray(I))
        return v

    @classmethod
    def from_1_to_n(cls, n, device=None):
        """Vector of values 1..n.

        >>> v = Vector.from_1_to_n(3)
        >>> print(v)
        0| 1
        1| 2
        2| 3
        """
        v = cls.sparse(types.INT64, n, device=device)
        v._build(np.arange(n, dtype=np.int64),
                 np.arange(1, n + 1, dtype=np.int64))
        return v

    @classmethod
    def random(cls, typ, nvals, size=GxB_INDEX_MAX, make_pattern=False,
               seed=None, device=None):
        """Random vector (the JAX package's stdlib-random draw order, so
        seeded results agree).

        >>> v = Vector.random(types.INT64, 3, 10, seed=42)
        >>> v.nvals <= 3 and v.size == 10
        True
        """
        from .matrix import _random_value_fn

        V = cls.sparse(typ, size, device=device)
        if seed is not None:
            _stdlib_random.seed(seed)
        if V.size == 0:
            nvals = 0
        f = _random_value_fn(typ)
        for _ in range(nvals):
            i = _stdlib_random.randint(0, V.size - 1)
            V[i] = typ.default_one if make_pattern else f()
        return V

    @classmethod
    def from_numpy(cls, arr, device=None):
        """Dense vector from a 1-D numpy array.

        >>> import numpy as np
        >>> print(Vector.from_numpy(np.array([1, 2, 3])))
        0| 1
        1| 2
        2| 3
        """
        arr = np.asarray(arr)
        typ = types.MetaType._dtype_type_map[arr.dtype.type]
        v = cls.sparse(typ, arr.shape[0], device=device)
        v._build(np.arange(arr.shape[0], dtype=np.int64), arr)
        return v

    @classmethod
    def _from_parts(cls, typ, vals, mask=None):
        """A bitmap vector holding the tensors (vals, mask) (mask None:
        every entry present), on their device."""
        out = cls.sparse(typ, vals.shape[0], device=vals.device)
        if mask is None:
            mask = torch.ones(vals.shape, dtype=torch.bool,
                              device=vals.device)
        out._set_dense(vals, mask)
        return out

    # ------------------------------------------------------------------
    # internal plumbing (mirrors Matrix)
    # ------------------------------------------------------------------

    def _device(self):
        """This vector's device, the default one if it holds none yet."""
        if self._dev is None:
            self._dev = resolve_device(None)
        return self._dev

    @property
    def device(self):
        """The device this vector's tensors live on (None until its
        first device work when built without one)."""
        return self._dev

    @property
    def _staged(self):
        return self._fmt == "bitmap" and self._vals is None

    def _invalidate(self):
        self._nvals_c = None
        self._host_c = None

    def _scatter(self, i, v):
        """Write host (index, value) arrays into the dense tensors."""
        dev = self._device()
        idx = torch.as_tensor(i, device=dev)
        vals = self._vals.clone()
        mask = self._mask.clone()
        vals[idx] = self.type.to_torch(v, dev)
        mask[idx] = True
        self._vals, self._mask = vals, mask

    def _build(self, I, V):
        I = np.asarray(I)
        _check_indices(I, self._size)
        i, _, v = ck.build(I, np.zeros_like(I), V, self.type._numpy_t)
        if self._fmt == "bitmap":
            if self._staged:
                self._idx_h, _, self._vals_h = ck.merge_pending(
                    self._idx_h, np.zeros_like(self._idx_h), self._vals_h,
                    i, np.zeros_like(i), v, self.type._numpy_t)
            else:
                self._scatter(i, v)
        else:
            self._idx_h, self._vals_h = i, v
        self._invalidate()

    def _flush(self):
        if not self._pending:
            return
        pend = self._pending
        self._pending = []
        I = np.asarray([p[0] for p in pend], np.int64)
        V = np.asarray([p[1] for p in pend], self.type._numpy_t)
        I2, _, V2 = ck.build(I, np.zeros_like(I), V, self.type._numpy_t)
        if self._fmt == "iso":
            # a written iso vector decays to COO (Matrix._flush)
            if self._size > (1 << 27):
                raise InsufficientSpace(
                    "iso vector too large to modify; copy to a sized "
                    "vector")
            self._fmt = "coo"
            self._idx_h = np.arange(self._size, dtype=np.int64)
            self._vals_h = np.full(self._size, self._iso_v,
                                   self.type._numpy_t)
            self._iso_v = None
        if self._fmt == "bitmap" and not self._staged:
            self._scatter(I2, V2)
        else:
            self._idx_h, _, self._vals_h = ck.merge_pending(
                self._idx_h, np.zeros_like(self._idx_h), self._vals_h,
                I2, np.zeros_like(I2), V2, self.type._numpy_t)
        self._invalidate()

    def _dense_pair(self, transpose=False):
        """Device (vals, mask); a staged bitmap vector moves to its
        device here, a COO one that fits is densified (not kept)."""
        self._flush()
        typ = self.type
        if self._fmt == "iso":
            if not self._fits_bitmap(self._size, typ):
                raise InsufficientSpace(
                    "iso vector too large to materialize")
            dev = self._device()
            return (torch.full((self._size,), typ.scalar(self._iso_v),
                               dtype=typ.torch_dtype, device=dev),
                    torch.ones(self._size, dtype=torch.bool, device=dev))
        if self._fmt == "bitmap" and not self._staged:
            return self._vals, self._mask
        if not self._fits_bitmap(self._size, typ):
            raise InsufficientSpace("vector too large for dense path")
        dev = self._device()
        v = torch.zeros(self._size, dtype=typ.torch_dtype, device=dev)
        m = torch.zeros(self._size, dtype=torch.bool, device=dev)
        if self._idx_h.size:
            idx = torch.as_tensor(self._idx_h, device=dev)
            v[idx] = typ.to_torch(self._vals_h, dev)
            m[idx] = True
        if self._staged:
            self._vals, self._mask = v, m
            self._idx_h = self._vals_h = None
        return v, m

    def _set_dense(self, vals, mask):
        self._fmt = "bitmap"
        self._idx_h = self._vals_h = None
        self._vals = vals
        self._mask = mask
        self._dev = vals.device
        self._invalidate()

    def _host_pair(self):
        """Host numpy (vals, mask): from the host arrays where the vector
        holds them, else from its tensors."""
        self._flush()
        if self._host_c is None:
            typ = self.type
            if self._fmt == "coo" or self._staged:
                if not self._fits_bitmap(self._size, typ):
                    raise InsufficientSpace("vector too large for dense "
                                            "path")
                v = np.zeros(self._size, typ._numpy_t)
                m = np.zeros(self._size, bool)
                v[self._idx_h] = self._vals_h
                m[self._idx_h] = True
            else:
                tv, tm = self._dense_pair()
                v, m = typ.to_numpy(tv), tm.cpu().numpy()
            self._host_c = (v, m)
        return self._host_c

    def _coo(self):
        self._flush()
        if self._fmt == "iso":
            if self._size > (1 << 27):
                raise InsufficientSpace(
                    "iso vector too large to enumerate")
            return (np.arange(self._size, dtype=np.int64),
                    np.full(self._size, self._iso_v, self.type._numpy_t))
        if self._fmt == "coo" or self._staged:
            return self._idx_h, self._vals_h
        v, m = self._host_pair()
        i = np.nonzero(m)[0]
        return i.astype(np.int64), v[i]

    def _writeback(self, out, t_vals, t_mask, mask, accum, desc):
        common_device(self, out, mask)
        if mask is not None:
            mv, mm = mask._dense_pair()
            if mv.shape != t_vals.shape:
                raise DimensionMismatch("mask size does not match output")
        else:
            mv = mm = None
        c_vals, c_mask = out._dense_pair()
        if c_vals.shape != t_vals.shape:
            raise DimensionMismatch("output size mismatch")
        nv, nm = dk.writeback(
            c_vals, c_mask, t_vals, t_mask, mv, mm,
            accum=accum, complement=desc.complement,
            structural=desc.structural, replace=desc.replace,
            typ=out.type)
        out._set_dense(nv, nm)
        return out

    def _get_args(self, mask=None, accum=None, desc=None):
        if accum is None:
            accum = current_accum.get(None)
        if accum is not None:
            accum = accum.get_op() if hasattr(accum, "get_op") else accum
        if desc is None:
            desc = current_desc.get(None)
        if desc is None:
            desc = Default
        return mask, accum, desc

    # ------------------------------------------------------------------
    # sparse (COO) writeback: the huge-vector twin of _writeback
    # ------------------------------------------------------------------

    def _set_coo(self, i, v):
        """Install canonical sorted index/value arrays as contents."""
        self._fmt = "coo"
        self._vals = self._mask = None
        self._pending = []
        self._idx_h = np.asarray(i, np.int64)
        self._vals_h = np.asarray(v).astype(self.type._numpy_t)
        self._invalidate()

    def _mask_pair_set(self, mask, desc):
        if mask is None:
            return None, None
        mi, mv = mask._coo()
        from .core import coosem as cs

        return cs.mask_pairs(mi, np.zeros_like(mi), mv, desc.structural)

    _SCALAR_FILL_BUDGET = 1 << 27

    def _assign_scalar_sparse(self, value, iset, mask, accum, desc):
        """Scalar assign on a huge vector: masked full fills take the
        mask's pattern; bounded regions materialize."""
        from .core import coosem as cs

        self._flush()
        val = self.type._coerce(value)
        if iset.kind == "all" and mask is not None \
                and not desc.complement:
            mpi, _ = self._mask_pair_set(mask, desc)
            tv = np.full(len(mpi), val, self.type._numpy_t)
            self._coo_writeback(self, mpi, tv, mask, accum, desc)
            return
        if iset.size > self._SCALAR_FILL_BUDGET:
            raise InsufficientSpace(
                "unbounded scalar fill on a huge vector requires a mask")
        I = np.arange(iset.size, dtype=np.int64)
        tv = np.full(iset.size, val, self.type._numpy_t)
        ci, cv = self._coo()
        mpi, _ = self._mask_pair_set(mask, desc)
        accum_fn = np_binop(accum) if accum is not None else None
        z = np.zeros_like
        nr, _, nv = cs.assign_region(
            ci, z(ci), cv, I, z(I), tv,
            cs.selector(iset, self._size), cs.ArithSelector(0, 1, 1),
            mpi, z(mpi) if mpi is not None else None,
            accum_fn, desc.complement, desc.replace, self.type._numpy_t)
        self._set_coo(nr, nv)

    def _ewise_huge(self, other, op, out, mask, accum, desc, union):
        """Element-wise union/intersection on huge vectors: the device
        sort engine (core/dewise.py) for large numeric inputs, the host
        sorted merge otherwise; full mask/accum semantics."""
        from .core import dewise as dw

        ia, va = self._coo()
        ib, vb = other._coo()
        dt = out.type._numpy_t
        dtk = np.dtype(dt)

        if (getattr(op, "udt", None) is None
                and getattr(op, "positional", None) is None
                and op.ztype_rule not in ("CMPLX",)
                and dtk.kind in "biuf"):
            max_i = int(max(ia[-1] if len(ia) else 0,
                            ib[-1] if len(ib) else 0))
            cdt = (np.promote_types(va.dtype, vb.dtype)
                   if op.ztype_rule == "BOOL" else dtk)
            if cdt.kind in "biuf" and dw.eligible(
                    len(ia), len(ib), max_i, 0, cdt, dtk):
                f = at_type(op, types._gb_from_dtype(cdt))
                r, _, v = dw.ewise(
                    ia, np.zeros_like(ia), va, ib, np.zeros_like(ib),
                    vb, f.apply, cdt, dtk, union=union,
                    device=common_device(self, other))
                return self._coo_writeback(out, r, v, mask, accum, desc)

        f = np_binop(op)

        def fn(x, y):
            if getattr(op, "udt", None) is None \
                    and op.ztype_rule != "BOOL":
                x = x.astype(dt)
                y = y.astype(dt)
            return f(x, y)

        r, _, v = ck.ewise(ia, np.zeros_like(ia), va, ib,
                           np.zeros_like(ib), vb, fn, dt, union=union)
        return self._coo_writeback(out, r, v, mask, accum, desc)

    def _coo_writeback(self, out, ti, tv, mask, accum, desc):
        """w<m> (accum)= t with t as canonical (idx, vals) arrays.

        When the output fits the dense budget the entries are scattered
        into tensors and the dense writeback runs; truly huge vectors go
        through the sorted-merge semantics of core/coosem.py."""
        from .core import coosem as cs

        if mask is not None and mask.shape[0] != out.size:
            raise DimensionMismatch("mask size does not match output")
        if out._fits_bitmap(out.size, out.type):
            dev = common_device(out, mask)
            typ = out.type
            tvd = torch.zeros(out.size, dtype=typ.torch_dtype, device=dev)
            tmd = torch.zeros(out.size, dtype=torch.bool, device=dev)
            if len(ti):
                idx = torch.as_tensor(np.asarray(ti, np.int64), device=dev)
                tvd[idx] = typ.to_torch(np.asarray(tv), dev)
                tmd[idx] = True
            return self._writeback(out, tvd, tmd, mask, accum, desc)
        mpi, _ = self._mask_pair_set(mask, desc)
        ci, cv = out._coo()
        accum_fn = np_binop(accum) if accum is not None else None
        z = np.zeros_like
        nr, _, nv = cs.writeback(ci, z(ci), cv, np.asarray(ti, np.int64),
                                 z(np.asarray(ti, np.int64)),
                                 np.asarray(tv),
                                 mpi, z(mpi) if mpi is not None else None,
                                 accum_fn, desc.complement, desc.replace,
                                 out.type._numpy_t)
        out._set_coo(nr, nv)
        return out

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------

    @property
    def size(self):
        """Size of the vector.

        >>> Vector.from_list([1, 2, 3]).size
        3
        """
        return self._size

    @property
    def shape(self):
        """Tuple of (size,).

        >>> Vector.sparse(types.INT8, 7).shape
        (7,)
        """
        return (self._size,)

    @property
    def nvals(self):
        """Number of stored elements.

        >>> Vector.from_lists([0, 2], [1, 2]).nvals
        2
        """
        self._flush()
        if self._nvals_c is None:
            if self._fmt == "iso":
                self._nvals_c = self._size
            elif self._fmt == "coo" or self._staged:
                self._nvals_c = int(self._idx_h.size)
            else:
                self._nvals_c = int(self._mask.sum())
        return self._nvals_c

    @property
    def memory_usage(self):
        """Bytes used by this vector's storage.

        >>> Vector.from_list([1, 2, 3]).memory_usage > 0
        True
        """
        self._flush()
        if self._fmt == "iso":
            return np.dtype(self.type._numpy_t).itemsize
        if self._fmt == "coo" or self._staged:
            return self._idx_h.nbytes + self._vals_h.nbytes
        return (self._vals.element_size() * self._vals.numel()
                + self._mask.numel())

    @property
    def hyper_switch(self):
        """Hypersparsity switching threshold (parity knob).

        >>> v = Vector.from_list([1, 2, 3])
        >>> v.hyper_switch = 0.5
        >>> v.hyper_switch
        0.5
        """
        return self._hyper_switch

    @hyper_switch.setter
    def hyper_switch(self, switch):
        self._hyper_switch = float(switch)

    @property
    def sparsity(self):
        """Sparsity control bitmask; defaults to GxB_AUTO_SPARSITY
        (15).

        >>> v = Vector.from_list([1, 2, 3])
        >>> v.sparsity
        15
        >>> v.sparsity = 4
        >>> v.sparsity
        4
        """
        return self._sparsity

    @sparsity.setter
    def sparsity(self, sparsity):
        """Setting the control CONVERTS storage: 1|2 moves bitmap to
        sorted-COO; 4|8 moves COO to bitmap when the dense budget
        allows."""
        self._sparsity = int(sparsity)
        self._flush()
        wants_sparse = not (self._sparsity & 12)
        wants_dense = not (self._sparsity & 3)
        if wants_sparse and self._fmt == "bitmap":
            i, v = self._coo()
            self._set_coo(i, v)
        elif wants_dense and self._fmt == "coo" \
                and self._fits_bitmap(self._size, self.type):
            v, m = self._dense_pair()
            self._set_dense(v, m)

    @property
    def sparsity_status(self):
        """Current physical format: 1=hypersparse, 2=sparse, 4=bitmap,
        8=full.

        >>> Vector.from_lists([0, 2], [7, 9], 4).sparsity_status
        4
        >>> Vector.from_list([1, 2, 3]).sparsity_status
        8
        >>> Vector.sparse(types.INT64, 10**12).sparsity_status
        1
        """
        self._flush()
        if self._fmt == "iso":
            return 8
        if self._fmt == "coo":
            return 1
        if self.nvals == self._size:
            return 8
        return 4

    @property
    def gb_type(self):
        """The GraphBLAS type object of the Vector.

        >>> Vector.from_list([1, 2, 3]).gb_type == types.INT64
        True
        """
        return self.type

    @property
    def indices(self):
        """Array of indices of stored elements.

        >>> list(Vector.from_lists([0, 2], [1, 2]).indices)
        [0, 2]
        """
        return array("L", map(int, self._coo()[0]))

    @property
    def I(self):
        """Iterator over `Vector.indices`.

        >>> v = Vector.from_lists([0, 2], [7, 9], 4)
        >>> list(v.I)
        [0, 2]
        """
        return iter(self.indices)

    @property
    def npI(self):
        """numpy array of indices.

        >>> Vector.from_lists([0, 2], [7, 9], 4).npI
        array([0, 2], dtype=uint64)
        """
        return self._coo()[0].astype(np.uint64)

    @property
    def vals(self):
        """Array of stored values.

        >>> list(Vector.from_lists([0, 2], [7, 9], 4).vals)
        [7, 9]
        """
        v = self._coo()[1]
        if self.type._typecode is None:
            return list(map(self.type._to_value, v))
        return array(self.type._typecode, map(self.type._to_value, v))

    @property
    def V(self):
        """Iterator over `Vector.vals`.

        >>> list(Vector.from_lists([0, 2], [7, 9], 4).V)
        [7, 9]
        """
        return iter(self.vals)

    @property
    def npV(self):
        """numpy array of stored values.

        >>> Vector.from_lists([0, 2], [7, 9], 4).npV
        array([7, 9])
        """
        return np.asarray(self._coo()[1])

    def pattern(self, typ=types.BOOL):
        """BOOL pattern vector of stored elements.

        >>> print(Vector.from_lists([0, 2], [1, 2]).pattern())
        0| t
        1|
        2| t
        """
        out = Vector.sparse(typ, self.size, device=self._dev)
        return self.apply(typ.ONE, out=out)

    @property
    def S(self):
        """The vector structure; same as `Vector.pattern()`.

        >>> print(Vector.from_lists([0, 2], [7, 9], 3).S)
        0| t
        1|
        2| t
        """
        return self.pattern()

    # ------------------------------------------------------------------
    # lifecycle / element access
    # ------------------------------------------------------------------

    def dup(self):
        """Duplicate this Vector (independent of the original).

        >>> v = Vector.from_list([1, 2])
        >>> v.dup().iseq(v)
        True

        The duplicate is independent of the original:

        >>> w = v.dup()
        >>> w[0] = 9
        >>> v[0]
        1
        """
        out = Vector.sparse(self.type, self._size, device=self._dev)
        self._flush()
        if self._fmt == "bitmap" and not self._staged:
            out._set_dense(self._vals, self._mask)
        elif self._fmt == "iso":
            out._fmt = "iso"
            out._idx_h = out._vals_h = None
            out._iso_v = self._iso_v
        else:
            out._fmt = self._fmt
            out._idx_h = self._idx_h.copy()
            out._vals_h = self._vals_h.copy()
            out._invalidate()
        return out

    def cast(self, cast, out=None):
        """Cast this vector to another type.

        >>> v = Vector.from_list([1, 2, 3])
        >>> w = v.cast(types.FP32)
        >>> w.type is types.FP32
        True
        >>> print(w)
        0|1.0
        1|2.0
        2|3.0
        """
        if out is None:
            out = Vector.sparse(cast, self._size, device=self._dev)
        self._flush()
        if self._fmt == "bitmap" and out._fmt == "bitmap":
            common_device(self, out)
            v, m = self._dense_pair()
            out._set_dense(types.cast(v, self.type, out.type), m)
        else:
            i, v = self._coo()
            if out._fmt == "bitmap":
                out._vals = out._mask = None
                out._idx_h = i.copy()
                out._vals_h = v.astype(out.type._numpy_t)
                out._invalidate()
            else:
                out._set_coo(i.copy(), v.astype(out.type._numpy_t))
        return out

    def clear(self):
        """Remove all elements.

        >>> v = Vector.from_list([1, 2, 3])
        >>> v.clear()
        >>> v.nvals
        0
        """
        self._pending = []
        if self._fmt == "bitmap" and not self._staged:
            self._vals = torch.zeros_like(self._vals)
            self._mask = torch.zeros_like(self._mask)
        else:
            self._idx_h = np.empty(0, np.int64)
            self._vals_h = np.empty(0, self.type._numpy_t)
        self._invalidate()

    def resize(self, size=GxB_INDEX_MAX):
        """Resize; values beyond the new size are dropped.

        >>> v = Vector.from_list([1, 2, 3])
        >>> v.resize(10)
        >>> v.size
        10
        """
        i, v = self._coo()
        keep = i < size
        self._size = int(size)
        self._fmt = "bitmap" if self._fits_bitmap(size, self.type) else "coo"
        self._vals = self._mask = None
        self._idx_h = np.empty(0, np.int64)
        self._vals_h = np.empty(0, self.type._numpy_t)
        self._invalidate()
        self._build(i[keep], v[keep])

    def wait(self):
        """Complete all pending work on this Vector.

        >>> v = Vector.sparse(types.INT64, 3)
        >>> v[1] = 7
        >>> v.wait()
        >>> v.nvals
        1
        """
        self._flush()
        if self._fmt == "bitmap" and not self._staged \
                and self._vals.device.type == "cuda":
            torch.cuda.synchronize(self._vals.device)

    def __setitem__(self, index, value):
        """Write an element or region.

        >>> v = Vector.sparse(types.INT64, 3)
        >>> v[0] = 7
        >>> v[1:] = 9
        >>> print(v)
        0| 7
        1| 9
        2| 9
        """
        if _is_int(index):
            if not 0 <= index < self._size:
                raise InvalidIndex("index out of bounds")
            self._pending.append(
                (index, self.type._coerce(self.type._from_value(value))))
            self._invalidate()
            return
        if isinstance(index, slice):
            if isinstance(value, Vector):
                return self.assign(value, index)
            return self.assign_scalar(value, index)
        if isinstance(index, Vector):
            if isinstance(value, Vector):
                return self.assign(value, mask=index)
            return self.assign_scalar(value, mask=index)
        if isinstance(index, list):
            if isinstance(value, Vector):
                return self.assign(value, index)
            return self.assign_scalar(value, index)
        raise TypeError

    def __getitem__(self, index):
        """Read an element or sub-vector.

        >>> v = Vector.from_list([1, 2, 3])
        >>> v[1]
        2
        >>> print(v[0:1])
        0| 1
        1| 2
        """
        if _is_int(index):
            return self.extract_element(index)
        if not isinstance(index, (slice, list, np.ndarray, Vector)):
            raise TypeError(f"bad Vector index: {type(index)}")
        return self.extract(index)

    def __delitem__(self, index):
        """Remove a single stored element.

        >>> v = Vector.from_lists([0, 2], [7, 9], 3)
        >>> del v[0]
        >>> v.to_lists()
        [[2], [9]]
        """
        if not _is_int(index):
            raise TypeError("only single element removal supported")
        self._flush()
        if self._fmt == "coo" or self._staged:
            self._idx_h, _, self._vals_h, _ = ck.remove(
                self._idx_h, np.zeros_like(self._idx_h), self._vals_h,
                index, 0)
        else:
            vals = self._vals.clone()
            mask = self._mask.clone()
            mask[index] = False
            vals[index] = 0
            self._vals, self._mask = vals, mask
        self._invalidate()

    def __contains__(self, index):
        """True iff an element is stored at `index`.

        >>> v = Vector.from_lists([0, 2], [7, 9], 3)
        >>> 0 in v
        True
        >>> 1 in v
        False
        """
        try:
            self[index]
            return True
        except NoValue:
            return False

    def get(self, i, default=None):
        """Element at i or `default`.

        >>> Vector.from_lists([0], [42], 2).get(1, 'foo')
        'foo'
        """
        try:
            return self[i]
        except NoValue:
            return default

    def extract_element(self, index):
        """Extract a single element; raises NoValue if absent.

        >>> v = Vector.from_lists([0, 2], [7, 9], 3)
        >>> v.extract_element(2)
        9
        """
        if not 0 <= index < self._size:
            raise InvalidIndex("index out of bounds")
        self._flush()
        if self._fmt == "iso":
            return self.type._to_value(self._iso_v)
        if self._fmt == "coo" or self._staged:
            pos = ck.find(self._idx_h, np.zeros_like(self._idx_h), index, 0)
            if pos < 0:
                raise NoValue
            return self.type._to_value(self._vals_h[pos])
        v, m = self._host_pair()
        if not m[index]:
            raise NoValue
        return self.type._to_value(v[index])

    def extract(self, index, mask=None, accum=None, desc=None):
        """Extract a sub-vector by slice (stop inclusive) or index
        list.

        >>> v = Vector.from_list([1, 2, 3])
        >>> print(v.extract(slice(1, 2)))
        0| 2
        1| 3
        >>> print(v.extract([0, 2]))
        0| 1
        1| 3
        >>> print(v.extract(slice(2, 0, -1)))
        0| 3
        1| 2
        2| 1
        """
        mask, accum, desc = self._get_args(mask, accum, desc)
        iset = _build_range(index if not _is_int(index)
                            else slice(index, index), self._size - 1)
        if iset.size is None:
            iset.size = self._size
        out = Vector.sparse(self.type, iset.size, device=self._dev)
        if not self._fits_bitmap(self._size, self.type):
            from .core import coosem as cs

            i, v = self._coo()
            ent, pos = cs.selector(iset, self._size).select(i)
            order = np.argsort(pos, kind="stable")
            return out._coo_writeback(out, pos[order], v[ent][order],
                                      mask, accum, desc)
        dev = common_device(self, out, mask)
        I = np.asarray(iset.indices(self._size), np.int64)
        v, m = self._dense_pair()
        idx = torch.as_tensor(I, device=dev)
        return out._writeback(out, v[idx], m[idx], mask, accum, desc)

    def __iter__(self):
        """Iterate (index, value) pairs.

        >>> list(iter(Vector.from_lists([0, 2], [1, 2])))
        [(0, 1), (2, 2)]
        """
        i, v = self._coo()
        return zip(map(int, i), map(self.type._to_value, v))

    def to_lists(self):
        """Return [indices, values] lists.

        >>> Vector.from_lists([0, 2], [1, 2]).to_lists()
        [[0, 2], [1, 2]]
        """
        i, v = self._coo()
        return [list(map(int, i)), list(map(self.type._to_value, v))]

    def to_arrays(self):
        """Return (indices, values) as stdlib arrays.

        >>> Vector.from_lists([0, 2], [1, 2]).to_arrays()
        (array('L', [0, 2]), array('q', [1, 2]))
        """
        if self.type._typecode is None:
            raise TypeError("This vector has no array typecode.")
        i, v = self._coo()
        return (array("L", map(int, i)),
                array(self.type._typecode, map(self.type._to_value, v)))

    def to_numpy(self):
        """Dense numpy copy (absent entries read 0).

        >>> Vector.from_lists([0, 2], [7, 9], 3).to_numpy()
        array([7, 0, 9])
        """
        v, m = self._host_pair()
        return np.where(m, v, np.zeros((), v.dtype))

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    def to_string(self, format_string="{:>%s}", width=2, prec=3,
                  empty_char=""):
        """String rendering (the JAX package's layout).

        >>> Vector.from_lists([0, 2], [1, 2]).to_string()
        '0| 1\\n1|\\n2| 2'
        """
        format_string = format_string % width
        result = ""
        for row in range(self.size):
            value = self.get(row, empty_char)
            result += str(row) + "|"
            result += format_string.format(
                self.type.format_value(value, width, prec)).rstrip()
            if row < self.size - 1:
                result += "\n"
        return result

    def __str__(self):
        return self.to_string()

    def __repr__(self):
        tname = self.type.__name__
        if self._size == GxB_INDEX_MAX:
            return f"<Vector({tname}, nvals: {self.nvals})>"
        return f"<Vector({tname} size: {self.size}, nvals: {self.nvals})>"

    def print(self, level=2, name="v", f=None):  # pragma: no cover
        import sys

        f = f or sys.stdout
        print(f"GraphBLAS Vector {name}: {self.type.__name__} "
              f"size={self.size} nvals={self.nvals}", file=f)
        if level >= 3:
            print(self.to_string(), file=f)

    # ------------------------------------------------------------------
    # element-wise / apply / select
    # ------------------------------------------------------------------

    def _resolve_eop(self, op, for_eadd):
        if op is None:
            op = current_binop.get(None)
            if op is None:
                op = current_monoid.get(None)
        if isinstance(op, str):
            op = _get_bin_op(op, self.type)
        if isinstance(op, Semiring):
            op = op.add_monoid.binaryop if for_eadd else op.mul_op
        if isinstance(op, Monoid):
            op = op.binaryop
        return op

    @_timed("Vector.eadd")
    def eadd(self, other, add_op=None, cast=None, out=None, mask=None,
             accum=None, desc=None):
        """Element-wise union.

        >>> u = Vector.from_lists([0, 1], [1, 2], 3)
        >>> v = Vector.from_lists([1, 2], [10, 20], 3)
        >>> print(u.eadd(v))
        0| 1
        1|12
        2|20
        >>> print(u.eadd(v, types.INT64.MAX))
        0| 1
        1|10
        2|20
        """
        add_op = self._resolve_eop(add_op, True)
        mask, accum, desc = self._get_args(mask, accum, desc)
        if out is None:
            typ = cast or promote(self.type, other.type)
            out = Vector.sparse(typ, self.size, device=self._dev)
        if add_op is None:
            add_op = out.type._default_addop()
        if self.size != other.size:
            raise DimensionMismatch("eadd size mismatch")
        if not self._fits_bitmap(self.size, self.type):
            return self._ewise_huge(other, add_op, out, mask, accum, desc,
                                    union=True)
        common_device(self, other, out, mask)
        av, am = self._dense_pair()
        bv, bm = other._dense_pair()
        tv, tm = dk.eadd(av, am, bv, bm, add_op, self.type, other.type,
                         out.type)
        return self._writeback(out, tv, tm, mask, accum, desc)

    union = eadd

    @_timed("Vector.emult")
    def emult(self, other, mult_op=None, cast=None, out=None, mask=None,
              accum=None, desc=None):
        """Element-wise intersection.

        >>> u = Vector.from_lists([0, 1], [1, 2], 3)
        >>> v = Vector.from_lists([1, 2], [10, 20], 3)
        >>> print(u.emult(v))
        0|
        1|20
        2|
        >>> print(u.emult(v, '+'))
        0|
        1|12
        2|
        """
        mult_op = self._resolve_eop(mult_op, False)
        mask, accum, desc = self._get_args(mask, accum, desc)
        if out is None:
            typ = cast or promote(self.type, other.type)
            out = Vector.sparse(typ, self.size, device=self._dev)
        if mult_op is None:
            mult_op = out.type._default_multop()
        if self.size != other.size:
            raise DimensionMismatch("emult size mismatch")
        if not self._fits_bitmap(self.size, self.type):
            return self._ewise_huge(other, mult_op, out, mask, accum,
                                    desc, union=False)
        common_device(self, other, out, mask)
        av, am = self._dense_pair()
        bv, bm = other._dense_pair()
        ztype = mult_op.ztype(self.type)
        tv, tm = dk.emult(av, am, bv, bm, mult_op, self.type, other.type,
                          ztype)
        return self._writeback(out, types.cast(tv, ztype, out.type), tm,
                               mask, accum, desc)

    intersection = emult

    def all(self, other, op):
        """True iff same size/pattern and op holds for all matched
        values.

        >>> v = Vector.from_list([1, 2, 3])
        >>> v.all(Vector.from_list([1, 2, 3]), types.INT64.EQ)
        True
        >>> v.all(Vector.from_list([1, 2, 4]), types.INT64.LE)
        True
        """
        if self.size != other.size:
            return False
        if self.nvals != other.nvals:
            return False
        C = self.emult(other, op, cast=types.BOOL)
        if C.nvals != self.nvals:
            return False
        return C.reduce_bool(types.BOOL.LAND_MONOID)

    def iseq(self, other, eq_op=None):
        """True iff structurally and numerically equal.

        >>> v = Vector.from_list([1, 2])
        >>> v.iseq(v.dup())
        True
        >>> v.iseq(Vector.from_list([1, 3]))
        False
        """
        if eq_op is None:
            if self.type != other.type:
                return False
            eq_op = self.type.EQ
        return self.all(other, eq_op)

    def isne(self, other):
        """Not `iseq`.

        >>> v = Vector.from_list([1, 2])
        >>> v.isne(Vector.from_list([1, 3]))
        True
        >>> v.isne(v)
        False
        """
        return not self.iseq(other)

    @_timed("Vector.apply")
    def apply(self, op, out=None, mask=None, accum=None, desc=None):
        """Apply a unary operator to every element.

        >>> print(Vector.from_list([-1, 2]).apply(types.INT64.AINV))
        0| 1
        1|-2
        >>> print(Vector.from_list([-1, 2]).apply(types.INT64.ABS))
        0| 1
        1| 2
        """
        if isinstance(op, _pytypes.FunctionType):
            from .unaryop import UnaryOp

            op = UnaryOp(op.__name__, self.type.__name__, fn=op, attach=False)
        mask, accum, desc = self._get_args(mask, accum, desc)
        ztype = op.ztype(self.type)
        if out is None:
            out = Vector.sparse(ztype, self.size, device=self._dev)
        if not self._fits_bitmap(self.size, self.type):
            i, v = self._coo()
            dev = common_device(self, out, mask)
            if op.positional is not None:
                it = torch.as_tensor(i, device=dev)
                nv = op.apply(None, dict(i=it, j=it))
            else:
                f = unary_at_type(op, self.type)
                nv = types.cast(f.apply(self.type.to_torch(v, dev)),
                                f.ztype(self.type), ztype)
            return self._coo_writeback(
                out, i, ztype.to_numpy(nv.to(ztype.torch_dtype))
                .astype(out.type._numpy_t), mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair()
        tv, tm = dk.apply_unary(v, m, op, self.type, ztype)
        return self._writeback(out, types.cast(tv, ztype, out.type), tm,
                               mask, accum, desc)

    def apply_first(self, first, op, out=None, mask=None, accum=None,
                    desc=None):
        """Binary op with bound first scalar operand.

        >>> print(Vector.from_list([1, 2]).apply_first(10, types.INT64.MINUS))
        0| 9
        1| 8
        """
        return self._apply_bound(first, op, True, out, mask, accum, desc)

    def apply_second(self, op, second, out=None, mask=None, accum=None,
                     desc=None):
        """Binary op with bound second scalar operand.

        >>> print(Vector.from_list([1, 2]).apply_second(types.INT64.MINUS, 10))
        0|-9
        1|-8
        """
        return self._apply_bound(second, op, False, out, mask, accum, desc)

    def _apply_bound(self, scalar, op, bind_first, out, mask, accum, desc):
        mask, accum, desc = self._get_args(mask, accum, desc)
        if isinstance(scalar, Scalar):
            scalar = scalar[0]
        ztype = op.ztype(self.type)
        if out is None:
            out = Vector.sparse(ztype, self.size, device=self._dev)
        if not self._fits_bitmap(self.size, self.type):
            return self._apply_bound_sparse(op, scalar, bind_first, out,
                                            mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair()
        tv, tm = dk.apply_binary_bound(v, m, self.type._coerce(scalar), op,
                                       self.type, ztype, bind_first)
        return self._writeback(out, types.cast(tv, ztype, out.type), tm,
                               mask, accum, desc)

    def _apply_bound_sparse(self, op, scalar, bind_first, out, mask,
                            accum, desc):
        i, v = self._coo()
        dev = common_device(self, out, mask)
        vt = self.type.to_torch(v, dev)
        ztype = op.ztype(self.type)
        m = torch.ones(vt.shape, dtype=torch.bool, device=dev)
        if op.positional is not None:
            it = torch.as_tensor(i, device=dev)
            z = op.apply(vt, vt, dict(i0=it, j0=it, i1=it, j1=it))
            z = z.to(ztype.torch_dtype)
        else:
            z, _ = dk.apply_binary_bound(vt, m, self.type._coerce(scalar),
                                         op, self.type, ztype, bind_first)
        return self._coo_writeback(
            out, i, ztype.to_numpy(z).astype(out.type._numpy_t),
            mask, accum, desc)

    @_timed("Vector.select")
    def select(self, op, thunk=None, out=None, mask=None, accum=None,
               desc=None):
        """Select elements matching a predicate (same string table as
        `Matrix.select`).

        >>> v = Vector.from_lists([0, 1, 2], [-1, 0, 1])
        >>> print(v.select('>0'))
        0|
        1|
        2| 1
        >>> v.select('<0').nvals
        1
        >>> print(v.select('>', 0))
        0|
        1|
        2| 1
        """
        if out is None:
            out = Vector.sparse(self.type, self.size, device=self._dev)
        if isinstance(op, str):
            if op == "min":
                thunk = self.reduce_float(self.type.min_monoid)
                op = _get_select_op("==")
            elif op == "max":
                thunk = self.reduce_float(self.type.max_monoid)
                op = _get_select_op("==")
            else:
                op = _get_select_op(op)
        elif isinstance(op, _pytypes.FunctionType):
            op = SelectOp(op.__name__, op, needs_thunk=True)
        if isinstance(thunk, Scalar):
            thunk = thunk[0]
        if thunk is None:
            thunk = DEFAULT_THUNKS.get(op.name) or 0
        op = op.at_type(self.type)
        mask, accum, desc = self._get_args(mask, accum, desc)
        th = self.type.scalar(self.type._coerce(thunk))
        if not self._fits_bitmap(self.size, self.type):
            i, v = self._coo()
            dev = common_device(self, out, mask)
            it = torch.as_tensor(i, device=dev)
            keep = op.apply(it, it, self.type.to_torch(v, dev),
                            torch.as_tensor(th, device=dev))
            keep = keep.cpu().numpy()
            return self._coo_writeback(
                out, i[keep], v[keep].astype(out.type._numpy_t),
                mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair()
        tv, tm = dk.select(v, m, torch.as_tensor(th, device=v.device), op)
        return self._writeback(out, types.cast(tv, self.type, out.type), tm,
                               mask, accum, desc)

    def nonzero(self):
        """Select the non-zero entries.

        >>> print(Vector.from_lists([0, 1, 2], [1, 0, 3], 3).nonzero())
        0| 1
        1|
        2| 3
        """
        from . import selectop

        return self.select(selectop.NONZERO)

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------

    def _reduce_pair(self):
        """(vals, mask) tensors for scalar reductions: the dense pair, or
        the COO value vector for huge vectors (every stored value
        present)."""
        if not self._fits_bitmap(self._size, self.type):
            _, v = self._coo()
            dev = self._device()
            if v.size:
                return (self.type.to_torch(v, dev),
                        torch.ones(v.size, dtype=torch.bool, device=dev))
            return (torch.zeros(1, dtype=self.type.torch_dtype, device=dev),
                    torch.zeros(1, dtype=torch.bool, device=dev))
        return self._dense_pair()

    def _iso_reduce(self, mon):
        """Closed-form fold of an O(1) iso vector (n copies of one value)
        for the standard monoids; None when not applicable."""
        self._flush()
        if self._fmt != "iso":
            return None
        op = mon.binaryop.op
        v = self._iso_v
        n = self._size
        if op in ("MIN", "MAX", "ANY", "LOR", "LAND", "BOR", "BAND"):
            return v  # idempotent
        npdt = np.dtype(self.type._numpy_t)

        def _wrap(r):
            bits = npdt.itemsize * 8
            r %= 1 << bits
            if npdt.kind == "i" and r >= 1 << (bits - 1):
                r -= 1 << bits
            return npdt.type(r)

        if op == "PLUS":
            if npdt.kind in "iu":
                return _wrap(int(v) * n)
            return npdt.type(v * n)
        if op == "TIMES":
            if npdt.kind in "iu":
                return _wrap(pow(int(v), n, 1 << (npdt.itemsize * 8)))
            return npdt.type(np.float64(v) ** n)
        if op in ("LXOR", "BXOR"):
            return npdt.type(v if n % 2 else 0)
        return None

    def _reduce_to(self, mon, typ, accum):
        """The monoid's fold of every present value cast to `typ`, then
        the accumulator: a numpy scalar of typ."""
        from .matrix import _reduce_accum

        v, m = self._reduce_pair()
        r = dk.reduce_all(types.cast(v, self.type, typ), m, mon, typ)
        return _reduce_accum(accum, typ.to_numpy(r), typ._numpy_t)

    @_timed("Vector.reduce")
    def reduce(self, mon=None, accum=None, desc=None):
        """Type-generic reduce to a scalar of this vector's type.

        >>> Vector.from_list([1, 2, 3]).reduce()
        6
        >>> Vector.from_list([1, 2, 3]).reduce(types.INT64.MIN_MONOID)
        1
        """
        if mon is None:
            mon = current_monoid.get(None)
            if mon is None:
                mon = getattr(self.type,
                              self.type._default_addop().op + "_MONOID")
        _, accum, desc = self._get_args(None, accum, desc)
        if getattr(self.type, "member_def", None):
            # struct UDT: identity-free pairwise tree fold on the host
            _, v = self._coo()
            if len(v) == 0:
                raise NoValue
            add = np_binop(mon.binaryop)
            while len(v) > 1:
                k = (len(v) // 2) * 2
                merged = np.asarray(add(v[0:k:2], v[1:k:2]))
                v = (merged if k == len(v)
                     else np.concatenate([merged, v[k:]]))
            return self.type._to_value(v[0])
        from .matrix import _reduce_accum

        npt = self.type._numpy_t
        iso_r = self._iso_reduce(mon)
        if iso_r is not None:
            return self.type._to_value(np.asarray(_reduce_accum(
                accum, np.asarray(iso_r), npt)).astype(npt))
        return self.type._to_value(
            np.asarray(self._reduce_to(mon, self.type, accum)).astype(npt))

    def reduce_bool(self, mon=None, mask=None, accum=None, desc=None):
        """Reduce to a bool (default LOR monoid).

        >>> Vector.from_list([False, True]).reduce_bool()
        True
        """
        if mon is None:
            mon = current_monoid.get(None) or types.BOOL.LOR_MONOID
        _, accum, desc = self._get_args(None, accum, desc)
        from .matrix import _reduce_accum

        iso_r = self._iso_reduce(mon)
        if iso_r is not None:
            return bool(_reduce_accum(accum, np.bool_(iso_r), np.bool_))
        return bool(self._reduce_to(mon, types.BOOL, accum))

    def reduce_int(self, mon=None, mask=None, accum=None, desc=None):
        """Reduce to an int (default PLUS monoid).

        >>> Vector.from_list([1, 2, 3]).reduce_int()
        6
        """
        if mon is None:
            mon = current_monoid.get(None) or types.INT64.PLUS_MONOID
        _, accum, desc = self._get_args(None, accum, desc)
        from .matrix import _reduce_accum

        iso_r = self._iso_reduce(mon)
        if iso_r is not None:
            return int(_reduce_accum(accum, np.int64(iso_r), np.int64))
        return int(self._reduce_to(mon, types.INT64, accum))

    def reduce_float(self, mon=None, mask=None, accum=None, desc=None):
        """Reduce to a float (default PLUS monoid).

        >>> Vector.from_list([1.5, 2.5]).reduce_float()
        4.0
        """
        if mon is None:
            mon = current_monoid.get(None) or self.type.PLUS_MONOID
        _, accum, desc = self._get_args(None, accum, desc)
        from .matrix import _reduce_accum

        iso_r = self._iso_reduce(mon)
        if iso_r is not None:
            return float(_reduce_accum(accum, np.float64(iso_r),
                                       np.float64))
        return float(self._reduce_to(mon, types.FP64, accum))

    def max(self):
        """Maximum stored value.

        >>> Vector.from_lists([0, 1, 2], [-42, 0, 149]).max()
        149
        """
        if self.type == types.BOOL:
            return self.reduce_bool(self.type.LOR_MONOID)
        if self.type in types._int_types:
            return self.reduce_int(self.type.MAX_MONOID)
        if self.type in types._float_types:
            return self.reduce_float(self.type.MAX_MONOID)
        raise TypeError("Un-maxable type")

    def min(self):
        """Minimum stored value.

        >>> Vector.from_lists([0, 1, 2], [-42, 0, 149]).min()
        -42
        """
        if self.type == types.BOOL:
            return self.reduce_bool(self.type.LAND_MONOID)
        if self.type in types._int_types:
            return self.reduce_int(self.type.MIN_MONOID)
        if self.type in types._float_types:
            return self.reduce_float(self.type.MIN_MONOID)
        raise TypeError("Un-minable type")

    # ------------------------------------------------------------------
    # vxm
    # ------------------------------------------------------------------

    @_timed("Vector.vxm")
    def vxm(self, other, semiring=None, cast=None, out=None, mask=None,
            accum=None, desc=None):
        """Vector-matrix multiply ("on the left"); ``v @ M``.

        >>> from .matrix import Matrix
        >>> M = Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3])
        >>> v = Vector.from_lists([0, 1, 2], [2, 3, 4])
        >>> print(v.vxm(M))
        0|12
        1| 2
        2| 6

        ``v @ M`` is the operator spelling:

        >>> print(v @ M)
        0|12
        1| 2
        2| 6
        """
        from .matrix import Matrix

        if semiring is None:
            semiring = current_semiring.get(None)
        mask, accum, desc = self._get_args(mask, accum, desc)
        # T1 transposes the matrix argument
        bnrows = other.ncols if desc.inp1 else other.nrows
        bncols = other.nrows if desc.inp1 else other.ncols
        if self.size != bnrows:
            raise DimensionMismatch(f"vxm: {self.size} != {bnrows}")
        if out is None:
            if semiring is not None:
                typ = semiring.ztype
            else:
                typ = cast or promote(self.type, other.type)
            out = Vector.sparse(typ, bncols, device=self._dev)
        if semiring is None:
            semiring = out.type._default_semiring()
        if other._fmt == "coo" and not Matrix._fits_bitmap(
                other.nrows, other.ncols, other.type):
            # vxm: the multiply's FIRST operand is the vector element
            return other._sparse_mxv(self, semiring, out, mask, accum, desc,
                                     transpose=not desc.inp1, flip_mul=True)
        common_device(self, other, out, mask)
        bv, bm = other._dense_pair(desc.inp1)
        xv, xm = self._dense_pair()
        zt = semiring.ztype
        tv, tm = dk.mxm(xv[None, :], xm[None, :], bv, bm, semiring,
                        np.dtype(zt._numpy_t))
        return self._writeback(out, types.cast(tv[0, :], zt, out.type),
                               tm[0, :], mask, accum, desc)

    def __matmul__(self, other):
        return self.vxm(other)

    def __imatmul__(self, other):
        return self.vxm(other, out=self)

    # ------------------------------------------------------------------
    # operator overloads
    # ------------------------------------------------------------------

    def __getattr__(self, name):
        """Look up operators as attributes: v.min_plus(M), v.ainv()."""
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            attr = getattr(self.type, name)
        except AttributeError:
            raise AttributeError(
                f"Vector has no attribute or type operator {name}")
        return partial(attr, self)

    def __len__(self):
        """Number of stored elements."""
        return self.nvals

    def __and__(self, other):
        return self.emult(other, current_binop.get(self.type.SECOND))

    def __iand__(self, other):
        return self.emult(other, current_binop.get(self.type.SECOND),
                          out=self)

    def __or__(self, other):
        return self.eadd(other, current_binop.get(self.type.SECOND))

    def __ior__(self, other):
        return self.eadd(other, current_binop.get(self.type.SECOND),
                         out=self)

    def _arith(self, other, name, ewise, out=None):
        op = current_binop.get(getattr(self.type, name))
        if not isinstance(other, Vector):
            return self.apply_second(op, other, out=out)
        return ewise(self, other, op, out=out)

    def _rarith(self, other, name, ewise):
        op = current_binop.get(getattr(self.type, name))
        if not isinstance(other, Vector):
            return self.apply_first(other, op)
        return ewise(other, self, op)  # pragma: no cover

    def __add__(self, other):
        """eadd with PLUS; a scalar operand binds apply_second.

        >>> v = Vector.from_list([1, 2, 3])
        >>> print(v + 1)
        0| 2
        1| 3
        2| 4
        """
        return self._arith(other, "PLUS", Vector.eadd)

    def __radd__(self, other):
        return self._rarith(other, "PLUS", Vector.eadd)

    def __iadd__(self, other):
        return self._arith(other, "PLUS", Vector.eadd, out=self)

    def __sub__(self, other):
        return self._arith(other, "MINUS", Vector.eadd)

    def __rsub__(self, other):
        return self._rarith(other, "MINUS", Vector.eadd)

    def __isub__(self, other):
        return self._arith(other, "MINUS", Vector.eadd, out=self)

    def __mul__(self, other):
        """emult with TIMES; a scalar operand binds apply_second.

        >>> v = Vector.from_list([1, 2, 3])
        >>> print(v * v)
        0| 1
        1| 4
        2| 9
        """
        return self._arith(other, "TIMES", Vector.emult)

    def __rmul__(self, other):
        return self._rarith(other, "TIMES", Vector.emult)

    def __imul__(self, other):
        return self._arith(other, "TIMES", Vector.emult, out=self)

    def __truediv__(self, other):
        return self._arith(other, "DIV", Vector.emult)

    def __rtruediv__(self, other):
        return self._rarith(other, "DIV", Vector.emult)

    def __itruediv__(self, other):
        return self._arith(other, "DIV", Vector.emult, out=self)

    def __invert__(self):
        return self.apply(self.type.MINV)

    def __neg__(self):
        """Additive inverse of every element.

        >>> print(-Vector.from_list([1, -2]))
        0|-1
        1| 2
        """
        return self.apply(self.type.AINV)

    def __abs__(self):
        """Absolute value of every element.

        >>> print(abs(Vector.from_list([-1, 2])))
        0| 1
        1| 2
        """
        return self.apply(self.type.ABS)

    # ------------------------------------------------------------------
    # comparison operators
    # ------------------------------------------------------------------

    def _full(self):
        B = self.__class__.sparse(self.type, self.size, device=self._dev)
        B.assign_scalar(self.type.default_one)
        return self.eadd(B, self.type.FIRST)

    def _compare(self, other, op, strop):
        C = self.__class__.sparse(types.BOOL, self.size, device=self._dev)
        if _is_scalar(other):
            if op(other, 0):
                B = self.__class__.dup(self)
                B[:] = other
                self.emult(B, strop, out=C)
                return C
            self.select(strop, other).apply(types.BOOL.ONE, out=C)
            return C
        if isinstance(other, Vector):
            A = self._full()
            B = other._full()
            A.emult(B, strop, out=C)
            return C
        raise TypeError("Unknown vector comparison type.")

    def __gt__(self, other):
        return self._compare(other, operator.gt, ">")

    def __lt__(self, other):
        return self._compare(other, operator.lt, "<")

    def __ge__(self, other):
        return self._compare(other, operator.ge, ">=")

    def __le__(self, other):
        return self._compare(other, operator.le, "<=")

    def __eq__(self, other):
        return self._compare(other, operator.eq, "==")

    def __ne__(self, other):
        return self._compare(other, operator.ne, "!=")

    __hash__ = None

    # ------------------------------------------------------------------
    # assign
    # ------------------------------------------------------------------

    def _region_writeback(self, I, xv, xm, mask, accum, desc):
        """w(I)<m> (accum)= x on the dense tensors: the mask restricted
        to the region when it spans the whole vector."""
        dev = common_device(self, mask)
        v, m = self._dense_pair()
        idx = torch.as_tensor(I, device=dev)
        sub_v, sub_m = v[idx], m[idx]
        mv, mm = (None, None)
        if mask is not None:
            mv, mm = mask._dense_pair()
            if mv.shape[0] == self._size:
                mv, mm = mv[idx], mm[idx]
        nv, nm = dk.writeback(sub_v, sub_m, xv, xm, mv, mm,
                              accum=accum, complement=desc.complement,
                              structural=desc.structural,
                              replace=desc.replace, typ=self.type)
        v2 = v.clone()
        m2 = m.clone()
        v2[idx] = nv
        m2[idx] = nm
        self._set_dense(v2, m2)

    @_timed("Vector.assign")
    def assign(self, value, index=None, mask=None, accum=None, desc=None):
        """Assign a sub-vector (GrB_Vector_assign; a slice is stop
        inclusive).

        >>> v = Vector.sparse(types.INT64, 3)
        >>> v.assign(Vector.from_list([9, 8, 7]))
        >>> print(v)
        0| 9
        1| 8
        2| 7

        A slice (stop-inclusive) assigns into part of the vector:

        >>> w = Vector.from_list([1, 2, 3])
        >>> w.assign(Vector.from_list([8, 9]), slice(1, 2))
        >>> print(w)
        0| 1
        1| 8
        2| 9
        """
        mask, accum, desc = self._get_args(mask, accum, desc)
        iset = _build_range(index if not _is_int(index)
                            else slice(index, index), self._size - 1)
        if iset.size is None:
            iset.size = self._size
        if iset.size != value.size:
            raise DimensionMismatch("assign length mismatch")
        if not self._fits_bitmap(self._size, self.type):
            from .core import coosem as cs

            self._flush()
            ti, tv = value._coo()
            if iset.kind == "all" and iset.size == self._size:
                self._coo_writeback(self, ti,
                                    tv.astype(self.type._numpy_t),
                                    mask, accum, desc)
                return
            ci, cv = self._coo()
            mpi, _ = self._mask_pair_set(mask, desc)
            accum_fn = np_binop(accum) if accum is not None else None
            z = np.zeros_like
            nr, _, nv = cs.assign_region(
                ci, z(ci), cv, ti, z(ti), tv.astype(self.type._numpy_t),
                cs.selector(iset, self._size), cs.ArithSelector(0, 1, 1),
                mpi, z(mpi) if mpi is not None else None,
                accum_fn, desc.complement, desc.replace,
                self.type._numpy_t)
            self._set_coo(nr, nv)
            return
        I = np.asarray(iset.indices(self._size), np.int64)
        self._flush()
        common_device(self, value, mask)
        xv, xm = value._dense_pair()
        xv = types.cast(xv, value.type, self.type)
        if len(I) == self._size and np.array_equal(I, np.arange(self._size)):
            self._writeback(self, xv, xm, mask, accum, desc)
            return
        self._region_writeback(I, xv, xm, mask, accum, desc)

    @_timed("Vector.assign_scalar")
    def assign_scalar(self, value, index=None, mask=None, accum=None,
                      desc=None):
        """Assign a scalar to a region of the Vector (all of it by
        default; with a mask, only the mask's pattern).

        >>> v = Vector.sparse(types.INT64, 3)
        >>> v.assign_scalar(42)
        >>> print(v)
        0|42
        1|42
        2|42

        With a mask, only the mask's pattern is written:

        >>> w = Vector.sparse(types.INT64, 3)
        >>> m = Vector.from_lists([0, 2], [True, True], 3)
        >>> w.assign_scalar(5, mask=m)
        >>> print(w)
        0| 5
        1|
        2| 5
        """
        mask, accum, desc = self._get_args(mask, accum, desc)
        iset = _build_range(index if not _is_int(index)
                            else slice(index, index), self._size - 1)
        if iset.size is None:
            iset.size = self._size
        if not self._fits_bitmap(self._size, self.type):
            return self._assign_scalar_sparse(value, iset, mask, accum,
                                              desc)
        self._flush()
        dev = common_device(self, mask)
        s = self.type.scalar(self.type._coerce(value))
        tdt = self.type.torch_dtype
        if iset.kind == "all":
            tv = torch.full((self._size,), s, dtype=tdt, device=dev)
            tm = torch.ones(self._size, dtype=torch.bool, device=dev)
            self._writeback(self, tv, tm, mask, accum, desc)
            return
        I = np.asarray(iset.indices(self._size), np.int64)
        tv = torch.full((len(I),), s, dtype=tdt, device=dev)
        tm = torch.ones(len(I), dtype=torch.bool, device=dev)
        self._region_writeback(I, tv, tm, mask, accum, desc)
