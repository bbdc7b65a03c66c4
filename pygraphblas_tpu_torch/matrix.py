"""The GraphBLAS Matrix container.

Counterpart of ``pygraphblas_tpu/matrix.py``.  A Matrix is a 2-D sparse
array over a GraphBLAS :class:`~.types.Type` in one of three formats,
picked by its dimensions as in the JAX package:

- **bitmap**: a (vals, mask) pair of tensors on one device while
  ``nrows * ncols`` fits ``bitmap_max_cells``; every operation is plain
  torch over them (``core/dense.py``).  Until its first device work a
  bitmap matrix holds its contents as canonical host COO triples and no
  tensor, so building one (``from_lists``, ``generators.to_matrix``)
  needs no device, and the fused loops and the SpGEMM read those triples
  directly.
- **coo**: host sorted COO triples for huge logical dimensions (up to
  ``GxB_INDEX_MAX``), shipped to the device as index arrays and plans
  for the sparse tiers: SpMV through the xspmv plan (the hand kernels),
  the csr8 gather pyramid, SpMSpV or the COO segment reduce
  (``_sparse_mxv``); SpGEMM through the masked SpGEMM or Gustavson/ESC
  (``_sparse_mxm``, the hand kernels on the card); element-wise work
  through the host merges or the device sort engine (``core/dewise``).
- **iso**: one repeated value past the dense budget, O(1).

Single-element writes are staged in a pending list and flushed in one
scatter on the next read.

Devices: every constructor takes ``device=``.  A matrix built without
one holds no tensor until it first does device work, which goes to the
device of the operation's other operands, else to the card (raising
when there is none).  Operations raise if their operands sit on
different devices; nothing falls back to the CPU.  Plans are cached per
device (``_ell_c``), and xspmv plans on disk as well (``core/xspmv``).

Extract and assign take GraphBLAS index sets (``A[1:3, 2]``,
``A[0, :]``, lists; slices are stop-inclusive, ``base._build_range``):
the bitmap tier gathers and scatters on the device (``dk.gather2d``,
``dk.scatter2d``), the COO tier maps host triples through selectors
(``coosem.extract``, ``coosem.assign_region``).  Not here yet: the I/O
constructors (``from_mm``, ``binread`` and the rest, ROADMAP item 11)
and ``shard`` (item 12).
"""

import operator
import os
import random as _stdlib_random
import types as _pytypes
from array import array
from functools import partial
from pathlib import Path

import numpy as np
import torch

from .base import (
    _timed,
    _build_range,
    IndexSet,
    GxB_INDEX_MAX,
    NoValue,
    DimensionMismatch,
    InsufficientSpace,
    InvalidValue,
    InvalidIndex,
    _get_bin_op,
    _get_select_op,
    config,
    burble,
)
from . import types
from .types import promote, _type_from_value
from .binaryop import at_type, current_accum, current_binop, np_binop
from .unaryop import at_type as unary_at_type
from .monoid import Monoid, current_monoid
from .semiring import Semiring, current_semiring
from .selectop import SelectOp, DEFAULT_THUNKS
from .descriptor import Default, T0, current_desc
from .scalar import Scalar
from ._device import as_tensor, common_device, resolve_device
from .core import dense as dk
from .core import coosparse as ck
from .core import coosem as cs
from .core import dewise as dw

__all__ = ["Matrix"]


def _is_scalar(x):
    return isinstance(x, (bool, int, float, complex, np.generic))


def _is_int(x):
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _reduce_accum(accum, value, np_dtype):
    """Scalar-reduction accumulator semantics: GrB_reduce with an accum
    combines the reduction into the zero-initialized result scalar:
    r = accum(0, reduce(A))."""
    if accum is None:
        return value
    accum = accum.get_op() if hasattr(accum, "get_op") else accum
    z = np.zeros(1, np_dtype)
    r = np.asarray(value).astype(np_dtype).reshape(1)
    return np.asarray(np_binop(accum)(z, r)).reshape(())


class Matrix:
    """GraphBLAS Matrix.

    Create with one of the constructor classmethods: `Matrix.sparse`,
    `Matrix.dense`, `Matrix.iso`, `Matrix.from_lists`, `Matrix.random`,
    `Matrix.identity`, `Matrix.from_scipy_sparse`, `Matrix.from_numpy`.
    """

    __slots__ = (
        "type",
        "_nrows",
        "_ncols",
        "_fmt",         # "bitmap" | "coo" | "iso"
        "_vals",        # bitmap: tensor (m, n), or None while staged
        "_mask",        # bitmap: bool tensor (m, n)
        "_rows_h",      # coo, and a staged bitmap: np.int64 sorted
        "_cols_h",
        "_vals_h",
        "_pending",     # list[(i, j, v)]
        "_nvals_c",     # cached host nvals (or None)
        "_host_c",      # cached host (vals, mask) snapshot for bitmap
        "_coo_t_c",     # cached transposed canonical COO (host)
        "_ell_c",       # per-matrix cache: plans, degrees, device COO
        "_diag_c",      # known-diagonal flag (constructor-set)
        "_format",      # BY_ROW / BY_COL orientation hint
        "_hyper_switch",
        "_sparsity",
        "_iso_v",       # iso format: the single repeated value
        "_dev",         # torch.device, or None until the first device work
    )

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def __init__(self, typ, nrows, ncols, fmt=None, device=None):
        self.type = typ
        self._nrows = int(nrows)
        self._ncols = int(ncols)
        self._pending = []
        self._nvals_c = None
        self._host_c = None
        self._coo_t_c = None
        self._ell_c = None
        self._diag_c = False
        self._format = config.format
        self._hyper_switch = config.hyper_switch
        self._sparsity = 15  # GxB_AUTO_SPARSITY
        self._iso_v = None
        self._dev = None if device is None else resolve_device(device)
        if fmt is None:
            fmt = "bitmap" if self._fits_bitmap(nrows, ncols, typ) else "coo"
        self._fmt = fmt
        self._vals = self._mask = None
        if fmt == "iso":
            self._rows_h = self._cols_h = self._vals_h = None
        else:
            self._rows_h = np.empty(0, np.int64)
            self._cols_h = np.empty(0, np.int64)
            self._vals_h = np.empty(0, typ._numpy_t)

    @staticmethod
    def _fits_bitmap(nrows, ncols, typ=None):
        if typ is not None and not typ._allows_bitmap:
            return False
        return nrows * ncols <= config.bitmap_max_cells

    @property
    def _is_huge(self):
        """True when this matrix can only live in sparse (COO) form."""
        return not self._fits_bitmap(self._nrows, self._ncols, self.type)

    @classmethod
    def sparse(cls, typ, nrows=None, ncols=None, fill=None, mask=None,
               device=None):
        """An empty sparse Matrix; unspecified dimensions default to
        `GxB_INDEX_MAX` (hypersparse, O(nnz) memory)."""
        if nrows is None:
            nrows = GxB_INDEX_MAX
        if ncols is None:
            ncols = GxB_INDEX_MAX
        m = cls(typ, nrows, ncols, device=device)
        if fill is not None and mask is not None:
            m.assign_scalar(fill, mask=mask)
        return m

    # scalar fills past this many cells cannot be enumerated
    _SCALAR_FILL_BUDGET = 1 << 24

    @classmethod
    def dense(cls, typ, nrows=None, ncols=None, fill=None, sparsity=None,
              device=None):
        """A dense Matrix: all elements present."""
        if nrows is None:
            nrows = GxB_INDEX_MAX
        if ncols is None:
            ncols = GxB_INDEX_MAX
        v = typ.default_zero if fill is None else fill
        if not cls._fits_bitmap(nrows, ncols, typ):
            if nrows * ncols > cls._SCALAR_FILL_BUDGET:
                raise InsufficientSpace(
                    "dense matrix too large for bitmap format")
            # forced-sparse configuration: materialize as full COO
            m = cls(typ, nrows, ncols, fmt="coo", device=device)
            I = np.repeat(np.arange(nrows, dtype=np.int64), ncols)
            J = np.tile(np.arange(ncols, dtype=np.int64), nrows)
            m._set_coo(I, J, np.full(len(I), typ._coerce(v), typ._numpy_t))
            return m
        m = cls(typ, nrows, ncols, fmt="bitmap", device=device)
        dev = m._device()
        shape = (m._nrows, m._ncols)
        m._set_dense(torch.full(shape, typ.scalar(typ._coerce(v)),
                                dtype=typ.torch_dtype, device=dev),
                     torch.ones(shape, dtype=torch.bool, device=dev))
        if sparsity is not None:
            m._sparsity = sparsity
        return m

    @classmethod
    def iso(cls, value, nrows=None, ncols=None, device=None):
        """A dense Matrix where every element is `value` (type inferred);
        past the dense budget the value is stored once (O(1))."""
        if nrows is None:
            nrows = GxB_INDEX_MAX
        if ncols is None:
            ncols = GxB_INDEX_MAX
        typ = _type_from_value(value)
        if not cls._fits_bitmap(nrows, ncols, typ):
            m = cls(typ, nrows, ncols, fmt="iso", device=device)
            m._iso_v = typ._coerce(value)
            return m
        return cls.dense(typ, nrows, ncols, fill=value, device=device)

    @classmethod
    def from_lists(cls, I, J, V=None, nrows=None, ncols=None, typ=None,
                   device=None):
        """A new matrix from lists of row indices, column indices and
        values (dimensions default to one past the largest index)."""
        if V is None:
            V = [True] * len(I)
            typ = types.BOOL if typ is None else typ
        if len(I) != len(J) or len(I) != len(V):
            raise InvalidValue("index and value lists must be the same length")
        if nrows is None:
            nrows = max(I) + 1
        if ncols is None:
            ncols = max(J) + 1
        if typ is None:
            typ = _type_from_value(V[0])
        m = cls.sparse(typ, nrows, ncols, device=device)
        m._build(np.asarray(I), np.asarray(J), np.asarray(V))
        return m

    @classmethod
    def random(cls, typ, nvals, nrows=GxB_INDEX_MAX, ncols=GxB_INDEX_MAX,
               make_pattern=False, make_symmetric=False,
               make_skew_symmetric=False, make_hermitian=True,
               no_diagonal=False, seed=None, device=None):
        """A random Matrix (the JAX package's stdlib-random draw order, so
        seeded results agree)."""
        M = cls.sparse(typ, nrows, ncols, device=device)
        if seed is not None:
            _stdlib_random.seed(seed)
        if typ in (types.BOOL, types.UINT8, types.UINT16, types.UINT32,
                   types.UINT64):
            make_skew_symmetric = False
        if M.nrows == 0 or M.ncols == 0:
            nvals = 0
        if M.nrows != M.ncols:
            make_symmetric = False
            make_skew_symmetric = False
            make_hermitian = False
        if make_pattern or make_symmetric:
            make_skew_symmetric = False
            make_hermitian = False
        if make_skew_symmetric:
            make_hermitian = False
            no_diagonal = True
        if typ not in (types.FC32, types.FC64):
            make_hermitian = False
        f = _random_value_fn(typ)
        I, J, V = [], [], []
        for _ in range(nvals):
            i = _stdlib_random.randint(0, M.nrows - 1)
            j = _stdlib_random.randint(0, M.ncols - 1)
            if no_diagonal and i == j:
                continue
            v = typ.default_one if make_pattern else f()
            I.append(i)
            J.append(j)
            V.append(v)
            if make_symmetric and i != j:
                I.append(j)
                J.append(i)
                V.append(v)
        M._build(np.asarray(I, np.int64), np.asarray(J, np.int64),
                 np.asarray(V))
        return M

    @classmethod
    def identity(cls, typ, nrows, value=None, device=None):
        """A square identity Matrix with its diagonal set to `value`
        (default: the type's one)."""
        result = cls.sparse(typ, nrows, nrows, device=device)
        if value is None:
            value = typ.default_one
        idx = np.arange(nrows, dtype=np.int64)
        result._build(idx, idx, np.full(nrows, typ._coerce(value)))
        result._diag_c = True
        return result

    @classmethod
    def from_scipy_sparse(cls, m, device=None):
        """From a scipy.sparse matrix; type inferred from its dtype."""
        ss = m.tocoo()
        nrows, ncols = ss.shape
        typ = types.MetaType._dtype_type_map[m.dtype.type]
        out = cls.sparse(typ, nrows, ncols, device=device)
        out._build(np.asarray(ss.row, np.int64), np.asarray(ss.col, np.int64),
                   np.asarray(ss.data))
        return out

    @classmethod
    def from_numpy(cls, arr, device=None):
        """A dense-pattern Matrix from a 2-D numpy array."""
        arr = np.asarray(arr)
        typ = types.MetaType._dtype_type_map[arr.dtype.type]
        out = cls.sparse(typ, arr.shape[0], arr.shape[1], device=device)
        I, J = np.nonzero(np.ones_like(arr, bool))
        out._build(I.astype(np.int64), J.astype(np.int64), arr[I, J])
        return out

    @classmethod
    def from_diag(cls, v, k=0, desc=None, device=None):
        """A square Matrix holding Vector `v`'s values along diagonal
        `k` (above the main one for k > 0); on `v`'s device unless one
        is named."""
        n = v.size + abs(k)
        m = cls.sparse(v.type, n, n,
                       device=v.device if device is None else device)
        I, V = v._coo()
        if k >= 0:
            m._build(I, I + k, V)
        else:
            m._build(I - k, I, V)
        if k == 0:
            m._diag_c = True
        return m

    @classmethod
    def from_mm(cls, mm_file, device=None):
        """From a MatrixMarket file or file-like object (coordinate
        format; INT64, FP64, BOOL or FC64 by its field).

        >>> import io
        >>> mm = io.StringIO(
        ...     "%%MatrixMarket matrix coordinate integer general\\n"
        ...     "2 2 2\\n1 2 7\\n2 1 9\\n")
        >>> print(Matrix.from_mm(mm))
              0  1
          0|     7|  0
          1|  9   |  1
              0  1
        """
        from .io.mm import read_mm

        I, J, V, nrows, ncols, typ = read_mm(mm_file)
        m = cls.sparse(typ, nrows, ncols, device=device)
        m._build(I, J, V)
        return m

    @classmethod
    def from_tsv(cls, tsv_file, typ, nrows, ncols, device=None, **kwargs):
        """From a tab-separated file of `row col val` lines (see
        `from_csv`).

        >>> import io
        >>> f = io.StringIO("1\\t2\\t7\\n2\\t1\\t9\\n")
        >>> print(Matrix.from_tsv(f, types.INT64, 2, 2))
              0  1
          0|     7|  0
          1|  9   |  1
              0  1
        """
        return cls.from_csv(tsv_file, typ, nrows, ncols, delimiter="\t",
                            device=device, **kwargs)

    @classmethod
    def from_csv(cls, csv_file, typ, nrows, ncols, one_based=True,
                 delimiter=",", device=None, **reader_args):
        """From a CSV file of `row, col, val` lines (1-based indices
        unless `one_based` is false; a line whose first field is not an
        integer, such as a header, is skipped).

        >>> import io
        >>> f = io.StringIO("1,2,7\\n2,1,9\\n")
        >>> print(Matrix.from_csv(f, types.INT64, 2, 2))
              0  1
          0|     7|  0
          1|  9   |  1
              0  1
        """
        import csv as csv_module

        if isinstance(csv_file, (str, Path)):
            fh = open(csv_file)
        else:
            fh = csv_file
        I, J, V = [], [], []
        kind = np.dtype(typ._numpy_t).kind
        cast = bool if kind == "b" else (float if kind in "fc" else int)
        try:
            rd = csv_module.reader(fh, delimiter=delimiter, **reader_args)
            for row in rd:
                if not row or len(row) < 3:
                    continue
                try:
                    i = int(row[0])
                except ValueError:
                    continue  # header
                j = int(row[1])
                if one_based:
                    i -= 1
                    j -= 1
                I.append(i)
                J.append(j)
                V.append(cast(row[2]))
        finally:
            if fh is not csv_file:
                fh.close()
        m = cls.sparse(typ, nrows, ncols, device=device)
        m._build(np.asarray(I, np.int64), np.asarray(J, np.int64),
                 np.asarray(V))
        return m

    @classmethod
    def binread(cls, bin_file, opener=Path.open, device=None):
        """Load a Matrix from a binary checkpoint written by `binwrite`
        (the JAX package's format: either package reads the other's).

        >>> import tempfile, os
        >>> M = Matrix.from_lists([0, 1], [1, 0], [7, 9], device="cpu")
        >>> path = os.path.join(tempfile.mkdtemp(), "m.binfile")
        >>> M.binwrite(path)
        >>> Matrix.binread(path, device="cpu").iseq(M)
        True
        """
        from .io.binfile import binread as _binread

        return _binread(cls, bin_file, opener, device=device)

    from_binfile = binread

    @classmethod
    def ssget(cls, name_or_id=None, binary_cache_dir=None, device=None):
        """Matrices of the SuiteSparse collection through the optional
        ``ssgetpy`` package (which downloads them): yields ``(filename,
        Matrix)`` pairs.  With `binary_cache_dir`, each MatrixMarket file
        is cached beside the download as a `.grb` binfile, and later
        calls skip the MatrixMarket parse."""
        import ssgetpy

        result = ssgetpy.search(name_or_id)[0]
        mm_path, _ = result.download(extract=True)
        mm_path = Path(mm_path)
        for m in sorted(mm_path.glob("*.mtx")):
            Mbin = mm_path / (m.name + ".grb")
            if binary_cache_dir and Mbin.exists():
                M = cls.from_binfile(Mbin, device=device)
            else:
                M = cls.from_mm(m, device=device)
                if binary_cache_dir:
                    M.to_binfile(Mbin)
            M.wait()
            yield m.name, M

    # ------------------------------------------------------------------
    # internal storage plumbing
    # ------------------------------------------------------------------

    def _device(self):
        """This matrix's device, the default one if it holds none yet."""
        if self._dev is None:
            self._dev = resolve_device(None)
        return self._dev

    @property
    def device(self):
        """The device this matrix's tensors and plans live on (None until
        its first device work when built without one)."""
        return self._dev

    @property
    def _staged(self):
        return self._fmt == "bitmap" and self._vals is None

    def _invalidate(self):
        self._nvals_c = None
        self._host_c = None
        self._coo_t_c = None
        self._ell_c = None
        self._diag_c = False

    def _cache(self):
        if self._ell_c is None:
            self._ell_c = {}
        return self._ell_c

    def _scatter(self, r, c, v):
        """Write host COO triples into the dense tensors."""
        dev = self._device()
        ri = torch.as_tensor(r, device=dev)
        ci = torch.as_tensor(c, device=dev)
        vals = self._vals.clone()
        mask = self._mask.clone()
        vals[ri, ci] = self.type.to_torch(v, dev)
        mask[ri, ci] = True
        self._vals, self._mask = vals, mask

    def _build(self, I, J, V):
        """Bulk-build from COO triples (later duplicates win).  An index
        at or past a dimension raises DimensionMismatch, as in the JAX
        package; a negative one raises IndexError."""
        I = np.asarray(I)
        J = np.asarray(J)
        if len(I):
            if I.max() >= self._nrows or J.max() >= self._ncols:
                raise DimensionMismatch("index out of bounds in build")
            if I.min() < 0 or J.min() < 0:
                raise IndexError("negative index in build")
        r, c, v = ck.build(I, J, V, self.type._numpy_t)
        if self._fmt == "bitmap":
            if self._staged:
                r, c, v = ck.merge_pending(self._rows_h, self._cols_h,
                                           self._vals_h, r, c, v,
                                           self.type._numpy_t)
                self._rows_h, self._cols_h, self._vals_h = r, c, v
            else:
                self._scatter(r, c, v)
        else:
            self._rows_h, self._cols_h, self._vals_h = r, c, v
        self._invalidate()

    def _flush(self):
        """Apply pending single-element writes in one vectorized scatter."""
        if not self._pending:
            return
        if self._fmt == "iso":
            # a written iso matrix is no longer iso: decay to COO when
            # enumerable
            if self._nrows * self._ncols > (1 << 27):
                raise InsufficientSpace(
                    "iso matrix too large to modify; copy to a sized "
                    "matrix")
            r = np.repeat(np.arange(self._nrows, dtype=np.int64),
                          self._ncols)
            c = np.tile(np.arange(self._ncols, dtype=np.int64),
                        self._nrows)
            self._fmt = "coo"
            self._rows_h, self._cols_h = r, c
            self._vals_h = np.full(r.size, self._iso_v,
                                   self.type._numpy_t)
            self._iso_v = None
        pend = self._pending
        self._pending = []
        I = np.asarray([p[0] for p in pend], np.int64)
        J = np.asarray([p[1] for p in pend], np.int64)
        V = np.asarray([p[2] for p in pend], self.type._numpy_t)
        I2, J2, V2 = ck.build(I, J, V, self.type._numpy_t)
        if self._fmt == "bitmap" and not self._staged:
            self._scatter(I2, J2, V2)
        else:
            self._rows_h, self._cols_h, self._vals_h = ck.merge_pending(
                self._rows_h, self._cols_h, self._vals_h, I2, J2, V2,
                self.type._numpy_t)
        self._invalidate()

    def _dense_pair(self, transpose=False):
        """Device (vals, mask): a staged bitmap matrix moves to its device
        here; a COO one that fits is densified (not kept)."""
        self._flush()
        typ = self.type
        shape = (self._nrows, self._ncols)
        if self._fmt == "iso":
            if not self._fits_bitmap(self._nrows, self._ncols, typ):
                raise InsufficientSpace(
                    "iso matrix too large to materialize")
            dev = self._device()
            v = torch.full(shape, typ.scalar(self._iso_v),
                           dtype=typ.torch_dtype, device=dev)
            m = torch.ones(shape, dtype=torch.bool, device=dev)
            return (v.t(), m.t()) if transpose else (v, m)
        if self._fmt == "bitmap" and not self._staged:
            v, m = self._vals, self._mask
        else:
            if not self._fits_bitmap(self._nrows, self._ncols, typ):
                raise InsufficientSpace(
                    "matrix too large for the dense execution path")
            dev = self._device()
            v = torch.zeros(shape, dtype=typ.torch_dtype, device=dev)
            m = torch.zeros(shape, dtype=torch.bool, device=dev)
            if self._rows_h.size:
                ri = torch.as_tensor(self._rows_h, device=dev)
                ci = torch.as_tensor(self._cols_h, device=dev)
                v[ri, ci] = typ.to_torch(self._vals_h, dev)
                m[ri, ci] = True
            if self._staged:
                self._vals, self._mask = v, m
                self._rows_h = self._cols_h = self._vals_h = None
        if transpose:
            return v.t(), m.t()
        return v, m

    @classmethod
    def _from_parts(cls, typ, nrows, ncols, vals, mask):
        out = cls.sparse(typ, nrows, ncols, device=vals.device)
        out._set_dense(vals, mask)
        return out

    def _out_like(self, typ=None, nrows=None, ncols=None):
        return Matrix.sparse(typ or self.type, nrows or self._nrows,
                             ncols or self._ncols, device=self._dev)

    def _set_dense(self, vals, mask):
        self._fmt = "bitmap"
        self._rows_h = self._cols_h = self._vals_h = None
        self._vals = vals
        self._mask = mask
        self._dev = vals.device
        self._invalidate()

    def _host_pair(self):
        """Host numpy snapshot of (vals, mask) for bitmap matrices."""
        self._flush()
        if self._host_c is None:
            if self._staged:
                v = np.zeros((self._nrows, self._ncols), self.type._numpy_t)
                m = np.zeros((self._nrows, self._ncols), bool)
                v[self._rows_h, self._cols_h] = self._vals_h
                m[self._rows_h, self._cols_h] = True
            else:
                tv, tm = self._dense_pair()
                v, m = self.type.to_numpy(tv), tm.cpu().numpy()
            self._host_c = (v, m)
        return self._host_c

    def _coo(self):
        """Host canonical COO triples (rows, cols, vals)."""
        self._flush()
        if self._fmt == "iso":
            if self._nrows * self._ncols > (1 << 27):
                raise InsufficientSpace(
                    "iso matrix too large to enumerate")
            r = np.repeat(np.arange(self._nrows, dtype=np.int64),
                          self._ncols)
            c = np.tile(np.arange(self._ncols, dtype=np.int64),
                        self._nrows)
            return r, c, np.full(r.size, self._iso_v, self.type._numpy_t)
        if self._fmt == "coo" or self._staged:
            return self._rows_h, self._cols_h, self._vals_h
        v, m = self._host_pair()
        r, c = np.nonzero(m)
        return r.astype(np.int64), c.astype(np.int64), v[r, c]

    def _coo_T(self):
        """Transposed canonical COO (col-major re-sort), cached: mxm needs
        B^T rows, and iterative algorithms re-multiply the same matrix."""
        if self._coo_t_c is None:
            r, c, v = self._coo()
            self._coo_t_c = ck.build(c, r, v, v.dtype)
        return self._coo_t_c

    # ------------------------------------------------------------------
    # writeback: C<M> (accum)= T, shared by every operation
    # ------------------------------------------------------------------

    def _writeback(self, out, t_vals, t_mask, mask, accum, desc):
        common_device(self, out, mask)
        if mask is not None:
            if not isinstance(mask, Matrix):
                raise TypeError("matrix operations take Matrix masks")
            mv, mm = mask._dense_pair()
            if mv.shape != t_vals.shape:
                raise DimensionMismatch("mask shape does not match output")
        else:
            mv = mm = None
        c_vals, c_mask = out._dense_pair()
        if c_vals.shape != t_vals.shape:
            raise DimensionMismatch(
                f"output shape {tuple(c_vals.shape)} != result shape "
                f"{tuple(t_vals.shape)}")
        nv, nm = dk.writeback(
            c_vals, c_mask, t_vals, t_mask, mv, mm,
            accum=accum,
            complement=desc.complement,
            structural=desc.structural,
            replace=desc.replace,
            typ=out.type,
        )
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
    # sparse (COO) writeback: the huge-matrix twin of _writeback, full
    # mask/accum/replace semantics at any logical dimension
    # ------------------------------------------------------------------

    def _set_coo(self, r, c, v):
        """Install canonical COO triples as this matrix's contents."""
        self._fmt = "coo"
        self._vals = self._mask = None
        self._pending = []
        self._rows_h = np.asarray(r, np.int64)
        self._cols_h = np.asarray(c, np.int64)
        self._vals_h = np.asarray(v).astype(self.type._numpy_t)
        self._invalidate()

    def _mask_pair_set(self, mask, desc):
        """The mask's TRUE (row, col) pair set for sparse writeback."""
        if mask is None:
            return None, None
        if not isinstance(mask, Matrix):
            raise TypeError("matrix operations take Matrix masks")
        mr, mc, mv = mask._coo()
        return cs.mask_pairs(mr, mc, mv, desc.structural)

    def _coo_writeback(self, out, tr, tc, tv, mask, accum, desc):
        """C<M> (accum)= T with T given as canonical COO triples."""
        if mask is not None and mask.shape != out.shape:
            raise DimensionMismatch("mask shape does not match output")
        mpr, mpc = self._mask_pair_set(mask, desc)
        cr, cc, cv = out._coo()
        accum_fn = np_binop(accum) if accum is not None else None
        nr, nc, nv = cs.writeback(cr, cc, cv, tr, tc,
                                  np.asarray(tv), mpr, mpc, accum_fn,
                                  desc.complement, desc.replace,
                                  out.type._numpy_t)
        out._set_coo(nr, nc, nv)
        return out

    _np_binop = staticmethod(np_binop)

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------

    @property
    def gb_type(self):
        """The GraphBLAS type object of the Matrix."""
        return self.type

    @property
    def nrows(self):
        """Number of rows."""
        return self._nrows

    @property
    def ncols(self):
        """Number of columns."""
        return self._ncols

    @property
    def shape(self):
        """Tuple of (nrows, ncols)."""
        return (self._nrows, self._ncols)

    @property
    def square(self):
        """True if the Matrix is square."""
        return self._nrows == self._ncols

    @property
    def nvals(self):
        """Number of stored elements."""
        self._flush()
        if self._nvals_c is None:
            if self._fmt == "iso":
                self._nvals_c = self._nrows * self._ncols
            elif self._fmt == "coo" or self._staged:
                self._nvals_c = int(self._rows_h.size)
            else:
                self._nvals_c = int(self._mask.sum())
        return self._nvals_c

    @property
    def memory_usage(self):
        """Bytes used by this matrix's storage."""
        self._flush()
        if self._fmt == "iso":
            return np.dtype(self.type._numpy_t).itemsize
        if self._fmt == "coo" or self._staged:
            return (self._rows_h.nbytes + self._cols_h.nbytes
                    + self._vals_h.nbytes)
        return (self._vals.element_size() * self._vals.numel()
                + self._mask.numel())

    @property
    def T(self):
        """Transposed copy (see `Matrix.transpose`)."""
        return self.transpose()

    @property
    def M(self):
        """The pattern mask of this matrix; see `Matrix.pattern`."""
        return self.pattern()

    @property
    def S(self):
        """The structure of this matrix; same as `Matrix.pattern()`."""
        return self.pattern()

    @property
    def hyper_switch(self):
        """Hypersparsity switching threshold (parity knob)."""
        return self._hyper_switch

    @hyper_switch.setter
    def hyper_switch(self, switch):
        self._hyper_switch = float(switch)

    @property
    def format(self):
        """Storage orientation: BY_ROW (0) or BY_COL (1)."""
        return self._format

    @format.setter
    def format(self, fmt):
        self._format = int(fmt)

    @property
    def sparsity(self):
        """Sparsity control (1=hyper 2=sparse 4=bitmap 8=full,
        15=auto)."""
        return self._sparsity

    @sparsity.setter
    def sparsity(self, sparsity):
        """Setting the control CONVERTS storage: 1|2 moves a bitmap
        matrix to sorted-COO; 4|8 moves COO to bitmap when the dense
        budget allows."""
        self._sparsity = int(sparsity)
        self._flush()
        wants_sparse = not (self._sparsity & 12)  # no bitmap/full bits
        wants_dense = not (self._sparsity & 3)    # no hyper/sparse bits
        if wants_sparse and self._fmt == "bitmap":
            r, c, v = self._coo()
            self._set_coo(r, c, v)
        elif wants_dense and self._fmt == "coo" \
                and self._fits_bitmap(self._nrows, self._ncols,
                                      self.type):
            v, m = self._dense_pair()
            self._set_dense(v, m)

    @property
    def sparsity_status(self):
        """Current physical format: 1=hypersparse, 2=sparse, 4=bitmap,
        8=full."""
        self._flush()
        if self._fmt == "iso":
            return 8
        if self._fmt == "coo":
            return 1
        if self.nvals == self._nrows * self._ncols:
            return 8
        return 4

    def pattern(self, typ=types.BOOL, out=None):
        """The pattern of the matrix: every present value set to the
        identity value of `typ` (default BOOL)."""
        if out is None:
            out = Matrix.sparse(typ, self.nrows, self.ncols, device=self._dev)
        return self.apply(typ.ONE, out=out)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def dup(self, clear=False):
        """A duplicate Matrix (or an empty same-shape one)."""
        out = Matrix.sparse(self.type, self._nrows, self._ncols,
                            device=self._dev)
        if clear:
            return out
        self._flush()
        if self._fmt == "bitmap" and not self._staged:
            out._set_dense(self._vals, self._mask)
        elif self._fmt == "iso":
            out._fmt = "iso"
            out._rows_h = out._cols_h = out._vals_h = None
            out._iso_v = self._iso_v
        else:
            out._fmt = self._fmt
            out._rows_h = self._rows_h.copy()
            out._cols_h = self._cols_h.copy()
            out._vals_h = self._vals_h.copy()
            out._invalidate()
        out._diag_c = self._diag_c
        return out

    def clear(self):
        """Remove all elements (dimensions unchanged)."""
        self._pending = []
        if self._fmt == "bitmap" and not self._staged:
            self._vals = torch.zeros_like(self._vals)
            self._mask = torch.zeros_like(self._mask)
        else:
            self._rows_h = np.empty(0, np.int64)
            self._cols_h = np.empty(0, np.int64)
            self._vals_h = np.empty(0, self.type._numpy_t)
        self._invalidate()

    def resize(self, nrows=GxB_INDEX_MAX, ncols=GxB_INDEX_MAX):
        """Resize in place; values outside the new bounds are dropped
        (the tier follows the new dimensions)."""
        r, c, v = self._coo()
        keep = (r < nrows) & (c < ncols)
        self._nrows = int(nrows)
        self._ncols = int(ncols)
        self._fmt = ("bitmap" if self._fits_bitmap(nrows, ncols, self.type)
                     else "coo")
        self._vals = self._mask = None
        self._rows_h = np.empty(0, np.int64)
        self._cols_h = np.empty(0, np.int64)
        self._vals_h = np.empty(0, self.type._numpy_t)
        self._invalidate()
        self._build(r[keep], c[keep], v[keep])

    def wait(self):
        """Barrier: complete all pending work on this Matrix."""
        self._flush()
        if self._fmt == "bitmap" and not self._staged \
                and self._vals.device.type == "cuda":
            torch.cuda.synchronize(self._vals.device)

    # ------------------------------------------------------------------
    # element access / iteration / export
    # ------------------------------------------------------------------

    def __setitem__(self, index, value):
        """Write an element, row, column or region: ``A[i, j] = v``,
        ``A[i] = vector``, ``A[:, j] = vector``, ``A[1:2, 0:3] = B``
        (slices stop-inclusive), ``A[M] = s`` (M a mask)."""
        from .vector import Vector

        if _is_int(index):
            if _is_scalar(value):
                return self.assign_scalar(value, index)
            if isinstance(value, Vector):
                return self.assign_row(index, value)
            raise TypeError
        if isinstance(index, slice):
            if isinstance(value, Matrix):
                return self.assign_matrix(value, index, None)
            if _is_scalar(value):
                return self.assign_scalar(value, index, None)
            raise TypeError
        if isinstance(index, Matrix):
            if isinstance(value, Matrix):
                return self.assign_matrix(value, mask=index)
            if _is_scalar(value):
                return self.assign_scalar(value, mask=index)
            raise TypeError
        if not isinstance(index, (tuple, list)):
            raise TypeError
        i0, i1 = index[0], index[1]
        if _is_int(i0) and _is_int(i1):
            if not (0 <= i0 < self._nrows and 0 <= i1 < self._ncols):
                raise InvalidIndex("index out of bounds")
            self._pending.append(
                (i0, i1, self.type._coerce(self.type._from_value(value))))
            self._invalidate()
            return
        if _is_int(i0) and isinstance(i1, slice):
            if isinstance(value, Vector):
                return self.assign_row(i0, value, i1)
            return self.assign_scalar(value, i0, i1)
        if isinstance(i0, slice) and _is_int(i1):
            if isinstance(value, Vector):
                return self.assign_col(i1, value, i0)
            return self.assign_scalar(value, i0, i1)
        if isinstance(i0, slice) and isinstance(i1, slice):
            if _is_scalar(value):
                return self.assign_scalar(value, i0, i1)
            return self.assign_matrix(value, i0, i1)
        raise TypeError

    def __getitem__(self, index):
        """Read an element (NoValue when absent), a row or column (a
        Vector) or a submatrix: ``A[i, j]``, ``A[i]``, ``A[1:3, 2]``,
        ``A[0:1, :]`` (slices stop-inclusive), ``A[M]`` (M a mask)."""
        if _is_int(index):
            return self.extract_row(index, None)
        if isinstance(index, slice):
            return self.extract_matrix(index, None)
        if isinstance(index, Matrix):
            return self.extract_matrix(mask=index)
        if not isinstance(index, (tuple, list)):
            raise TypeError
        i0, i1 = index[0], index[1]
        if _is_int(i0) and _is_int(i1):
            return self._extract_element(i0, i1)
        if _is_int(i0) and isinstance(i1, slice):
            return self.extract_row(i0, i1)
        if isinstance(i0, slice) and _is_int(i1):
            return self.extract_col(i1, i0)
        return self.extract_matrix(i0, i1)

    def _extract_element(self, i, j):
        if not (0 <= i < self._nrows and 0 <= j < self._ncols):
            raise InvalidIndex("index out of bounds")
        self._flush()
        if self._fmt == "iso":
            return self.type._to_value(self._iso_v)
        if self._fmt == "coo" or self._staged:
            pos = ck.find(self._rows_h, self._cols_h, i, j)
            if pos < 0:
                raise NoValue
            return self.type._to_value(self._vals_h[pos])
        v, m = self._host_pair()
        if not m[i, j]:
            raise NoValue
        return self.type._to_value(v[i, j])

    def __delitem__(self, index):
        """Remove a single stored element."""
        if (not isinstance(index, tuple) or not _is_int(index[0])
                or not _is_int(index[1])):
            raise TypeError("__delitem__ only supports single element removal")
        i, j = index
        self._flush()
        if self._fmt == "coo" or self._staged:
            self._rows_h, self._cols_h, self._vals_h, _ = ck.remove(
                self._rows_h, self._cols_h, self._vals_h, i, j)
        else:
            vals = self._vals.clone()
            mask = self._mask.clone()
            mask[i, j] = False
            vals[i, j] = 0
            self._vals, self._mask = vals, mask
        self._invalidate()

    def __contains__(self, index):
        """True iff an element is stored at (i, j)."""
        try:
            self[index]
            return True
        except NoValue:
            return False

    def get(self, i, j, default=None):
        """Element at (i, j), or `default` if not present."""
        try:
            return self[i, j]
        except NoValue:
            return default

    def __iter__(self):
        """Iterate (row, col, value) triples."""
        r, c, v = self._coo()
        return zip(map(int, r), map(int, c), map(self.type._to_value, v))

    def to_lists(self):
        """(row indices, col indices, values) as Python lists."""
        r, c, v = self._coo()
        return [list(map(int, r)), list(map(int, c)),
                list(map(self.type._to_value, v))]

    def to_arrays(self):
        """(rows, cols, vals) as stdlib array objects."""
        if self.type._typecode is None:
            raise TypeError("This matrix has no array typecode.")
        r, c, v = self._coo()
        return (array("L", map(int, r)), array("L", map(int, c)),
                array(self.type._typecode, map(self.type._to_value, v)))

    @property
    def rows(self):
        """Array of row indices of stored elements (row-major order)."""
        return array("L", map(int, self._coo()[0]))

    @property
    def I(self):
        """Iterator over `Matrix.rows`."""
        return iter(self.rows)

    @property
    def npI(self):
        """numpy array of row indices."""
        return self._coo()[0].astype(np.uint64)

    @property
    def cols(self):
        """Array of column indices of stored elements."""
        return array("L", map(int, self._coo()[1]))

    @property
    def J(self):
        """Iterator over `Matrix.cols`."""
        return iter(self.cols)

    @property
    def npJ(self):
        """numpy array of column indices."""
        return self._coo()[1].astype(np.uint64)

    @property
    def vals(self):
        """Array of stored values."""
        v = self._coo()[2]
        if self.type._typecode is None:
            return list(map(self.type._to_value, v))
        return array(self.type._typecode, map(self.type._to_value, v))

    @property
    def V(self):
        """Iterator over `Matrix.vals`."""
        return iter(self.vals)

    @property
    def npV(self):
        """numpy array of stored values."""
        return np.asarray(self._coo()[2])

    def to_scipy_sparse(self, format="csr"):
        """A scipy sparse matrix copy of this Matrix."""
        from scipy import sparse

        r, c, v = self._coo()
        s = sparse.coo_matrix((v, (r, c)), shape=self.shape,
                              dtype=self.type._numpy_t)
        if format == "coo":
            return s
        if format not in {"bsr", "csr", "csc", "coo", "lil", "dia", "dok"}:
            raise TypeError(f"Invalid format: {format}")
        return s.asformat(format)

    def to_numpy(self):
        """A dense numpy array copy of this Matrix."""
        self._flush()
        if self._fmt == "bitmap":
            v, m = self._host_pair()
            return np.where(m, v, np.zeros((), v.dtype))
        if self._nrows * self._ncols > self._SCALAR_FILL_BUDGET:
            raise InsufficientSpace("matrix too large to densify")
        r, c, v = self._coo()
        arr = np.zeros(self.shape, self.type._numpy_t)
        arr[r, c] = v
        return arr

    def binwrite(self, filename, comments="", opener=Path.open):
        """Write this Matrix to a binary checkpoint file (see `binread`).

        >>> import tempfile, os
        >>> M = Matrix.from_lists([0, 1], [1, 0], [7, 9], device="cpu")
        >>> path = os.path.join(tempfile.mkdtemp(), "m.binfile")
        >>> M.binwrite(path)
        >>> Matrix.binread(path, device="cpu").iseq(M)
        True
        """
        from .io.binfile import binwrite as _binwrite

        return _binwrite(self, filename, comments, opener)

    to_binfile = binwrite

    def to_mm(self, fileobj):
        """Write this Matrix to a MatrixMarket file or file-like object
        (coordinate, general; a bit view's values unsigned).

        >>> import io
        >>> M = Matrix.from_lists([0, 1], [1, 0], [7, 9])
        >>> f = io.StringIO()
        >>> M.to_mm(f)
        >>> print(f.getvalue(), end="")
        %%MatrixMarket matrix coordinate integer general
        2 2 2
        1 2 7
        2 1 9
        """
        from .io.mm import write_mm

        write_mm(self, fileobj)

    # ------------------------------------------------------------------
    # rendering (the JAX package's layouts; a bit view prints its
    # unsigned value, a BOOL t or f)
    # ------------------------------------------------------------------

    def to_string(self, format_string="{:>%s}", width=3, prec=5,
                  empty_char="", cell_sep=""):
        """ASCII grid rendering: a header of column numbers, one line a
        row with the row number on both sides."""
        format_string = format_string % width
        header = (format_string.format("") + " "
                  + "".join(format_string.format(i)
                            for i in range(self.ncols)))
        result = header + "\n"
        for row in range(self.nrows):
            result += format_string.format(row) + "|"
            for col in range(self.ncols):
                value = self.get(row, col, empty_char)
                result += cell_sep + self.type.format_value(value, width,
                                                            prec)
            result += "|  " + str(row) + "\n"
        result += header
        return result

    def __str__(self):
        return self.to_string()

    def __repr__(self):
        tname = self.type.__name__
        if self._nrows == GxB_INDEX_MAX and self._ncols == GxB_INDEX_MAX:
            return f"<Matrix({tname}, nvals: {self.nvals})>"
        return f"<Matrix({tname}, shape: {self.shape}, nvals: {self.nvals})>"

    def to_markdown_table(self, title="A", width=2):
        """Markdown-table rendering."""
        rows = []
        header = [title] + [str(j) for j in range(self.ncols)]
        rows.append("|".join(header))
        rows.append("|".join(["---"] * len(header)))
        for i in range(self.nrows):
            cells = [str(i)]
            for j in range(self.ncols):
                v = self.get(i, j)
                cells.append("" if v is None else str(v))
            rows.append("|".join(cells))
        return "\n".join(rows)

    def to_html_table(self, title="A", width=2):
        """HTML-table rendering for notebooks."""
        out = [f"<table><tr><th>{title}</th>"]
        for j in range(self.ncols):
            out.append(f"<th>{j}</th>")
        out.append("</tr>")
        for i in range(self.nrows):
            out.append(f"<tr><th>{i}</th>")
            for j in range(self.ncols):
                v = self.get(i, j)
                out.append("<td>%s</td>" % ("" if v is None else v))
            out.append("</tr>")
        out.append("</table>")
        return "".join(out)

    def _repr_html_(self):  # pragma: no cover
        return self.to_html_table()

    def print(self, level=2, name="A", f=None):
        """Print a diagnostic dump of the matrix (with the grid from
        level 3)."""
        import sys

        f = f or sys.stdout
        print(f"GraphBLAS Matrix {name}: {self.type.__name__} "
              f"{self.shape} nvals={self.nvals} fmt={self._fmt}", file=f)
        if level >= 3:
            print(self.to_string(), file=f)

    # ------------------------------------------------------------------
    # transpose / cast
    # ------------------------------------------------------------------

    @_timed("Matrix.transpose")
    def transpose(self, cast=None, out=None, mask=None, accum=None, desc=None):
        """Transpose (and optionally cast) the Matrix; with desc=T0 a cast
        or copy without transposing."""
        mask, accum, desc = self._get_args(mask, accum, desc)
        really_transpose = not desc.inp0
        if out is None:
            nr, nc = ((self._nrows, self._ncols) if not really_transpose
                      else (self._ncols, self._nrows))
            typ = cast if cast is not None else self.type
            out = Matrix.sparse(typ, nr, nc, device=self._dev)
        if self._is_huge or out._is_huge:
            # sparse path: host index swap + re-sort (O(nnz log nnz))
            r, c, v = self._coo()
            if really_transpose:
                r, c, v = ck.build(c, r, v, v.dtype)
            return self._coo_writeback(out, r, c,
                                       v.astype(out.type._numpy_t),
                                       mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair(really_transpose)
        return self._writeback(out, types.cast(v, self.type, out.type), m,
                               mask, accum, desc)

    def cast(self, cast, out=None):
        """Cast this matrix to another type."""
        return self.transpose(cast, out, desc=T0)

    # ------------------------------------------------------------------
    # element-wise ops
    # ------------------------------------------------------------------

    def _resolve_eop(self, op, default, for_eadd):
        """Resolve an eadd/emult operator argument: BinaryOp, Monoid,
        Semiring, or string."""
        if op is None:
            op = current_binop.get(None)
            if op is None:
                op = current_monoid.get(None)
            if op is None:
                op = default()
        if isinstance(op, str):
            op = _get_bin_op(op, self.type)
        if isinstance(op, Semiring):
            op = op.add_monoid.binaryop if for_eadd else op.mul_op
        if isinstance(op, Monoid):
            op = op.binaryop
        return op

    @_timed("Matrix.eadd")
    def eadd(self, other, add_op=None, cast=None, out=None, mask=None,
             accum=None, desc=None):
        """Element-wise union with `other`: the result pattern is the set
        union; the operator applies where both are present.  The operator
        may be a BinaryOp, a Monoid, a Semiring (its add monoid) or an
        operator string."""
        add_op = self._resolve_eop(add_op, lambda: None, True)
        mask, accum, desc = self._get_args(mask, accum, desc)
        if out is None:
            typ = cast or promote(self.type, other.type)
            out = Matrix.sparse(typ, self._nrows, self._ncols,
                                device=self._dev)
        if add_op is None:
            add_op = out.type._default_addop()
        if self._is_huge or other._is_huge:
            return self._ewise_huge(other, add_op, out, mask, accum, desc,
                                    union=True)
        common_device(self, other, out, mask)
        av, am = self._dense_pair(desc.inp0)
        bv, bm = other._dense_pair(desc.inp1)
        if av.shape != bv.shape:
            raise DimensionMismatch("eadd shape mismatch")
        tv, tm = dk.eadd(av, am, bv, bm, add_op, self.type, other.type,
                         out.type)
        return self._writeback(out, tv, tm, mask, accum, desc)

    def _ewise_huge(self, other, op, out, mask, accum, desc, union):
        """Element-wise union/intersection on huge COO matrices, full
        mask/accum semantics: large numeric inputs take the device sort
        engine (core/dewise.py), the rest the host merges
        (core/coosparse.py)."""
        ra, ca, va = self._coo()
        if desc.inp0:
            ra, ca, va = ck.build(ca, ra, va, va.dtype)
        rb, cb, vb = other._coo()
        if desc.inp1:
            rb, cb, vb = ck.build(cb, rb, vb, vb.dtype)
        dt = out.type._numpy_t

        dtk = np.dtype(dt)
        if (getattr(op, "udt", None) is None
                and getattr(op, "positional", None) is None
                and op.ztype_rule not in ("CMPLX",)
                and dtk.kind in "biuf"):
            max_r = int(max(ra[-1] if len(ra) else 0,
                            rb[-1] if len(rb) else 0))
            max_c = int(max(ca.max() if len(ca) else 0,
                            cb.max() if len(cb) else 0))
            if op.ztype_rule == "BOOL":
                cdt = np.promote_types(va.dtype, vb.dtype)
            else:
                cdt = dtk
            if cdt.kind in "biuf" and dw.eligible(
                    len(ra), len(rb), max_r, max_c, cdt, dt):
                burble("ewise: device sort engine (%d + %d nnz)",
                       len(ra), len(rb))
                f = at_type(op, types._gb_from_dtype(cdt))
                r, c, v = dw.ewise(
                    ra, ca, va, rb, cb, vb, f.apply, cdt, dtk, union=union,
                    device=common_device(self, other))
                return self._coo_writeback(out, r, c, v, mask, accum,
                                           desc)

        f = np_binop(op)

        def fn(x, y):
            if getattr(op, "udt", None) is None \
                    and op.ztype_rule != "BOOL":
                x = x.astype(dt)
                y = y.astype(dt)
            return f(x, y)

        r, c, v = ck.ewise(ra, ca, va, rb, cb, vb, fn, dt, union=union)
        return self._coo_writeback(out, r, c, v, mask, accum, desc)

    union = eadd

    @_timed("Matrix.emult")
    def emult(self, other, mult_op=None, cast=None, out=None, mask=None,
              accum=None, desc=None):
        """Element-wise intersection with `other`: the result pattern is
        the set intersection."""
        mult_op = self._resolve_eop(mult_op, lambda: None, False)
        mask, accum, desc = self._get_args(mask, accum, desc)
        if out is None:
            typ = cast or promote(self.type, other.type)
            out = Matrix.sparse(typ, self._nrows, self._ncols,
                                device=self._dev)
        if mult_op is None:
            mult_op = out.type._default_multop()
        if self._is_huge or other._is_huge:
            return self._ewise_huge(other, mult_op, out, mask, accum, desc,
                                    union=False)
        common_device(self, other, out, mask)
        av, am = self._dense_pair(desc.inp0)
        bv, bm = other._dense_pair(desc.inp1)
        if av.shape != bv.shape:
            raise DimensionMismatch("emult shape mismatch")
        ztype = mult_op.ztype(self.type)
        tv, tm = dk.emult(av, am, bv, bm, mult_op, self.type, other.type,
                          ztype)
        return self._writeback(out, types.cast(tv, ztype, out.type), tm,
                               mask, accum, desc)

    intersection = emult

    def all(self, other, op):
        """True iff the matrices have the same shape and pattern and `op`
        holds for every matched pair of values."""
        if self.shape != other.shape:
            return False
        if self.nvals != other.nvals:
            return False
        C = self.emult(other, op, cast=types.BOOL)
        if C.nvals != self.nvals:
            return False
        return C.reduce_bool(types.BOOL.LAND_MONOID)

    def iseq(self, other):
        """True iff structurally and numerically equal."""
        if self.type != other.type:
            return False
        return self.all(other, self.type.EQ)

    def isne(self, other):
        """True iff not equal; see `Matrix.iseq`."""
        return not self.iseq(other)

    # ------------------------------------------------------------------
    # apply / select
    # ------------------------------------------------------------------

    @_timed("Matrix.apply")
    def apply(self, op, out=None, mask=None, accum=None, desc=None):
        """Apply a unary operator to every element."""
        if isinstance(op, _pytypes.FunctionType):
            from .unaryop import UnaryOp

            op = UnaryOp(op.__name__, self.type.__name__, fn=op, attach=False)
        mask, accum, desc = self._get_args(mask, accum, desc)
        ztype = op.ztype(self.type)
        if out is None:
            out = Matrix.sparse(ztype, self._nrows, self._ncols,
                                device=self._dev)
        if self._is_huge:
            r, c, v = self._coo()
            if desc.inp0:
                r, c, v = ck.build(c, r, v, v.dtype)
            dev = common_device(self, out, mask)
            if op.positional is not None:
                nv = op.apply(None, dict(i=torch.as_tensor(r, device=dev),
                                         j=torch.as_tensor(c, device=dev)))
                nv = nv.to(ztype.torch_dtype)
            else:
                f = unary_at_type(op, self.type)
                nv = types.cast(f.apply(self.type.to_torch(v, dev)),
                                f.ztype(self.type), ztype)
            return self._coo_writeback(
                out, r, c, ztype.to_numpy(nv).astype(out.type._numpy_t),
                mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair(desc.inp0)
        tv, tm = dk.apply_unary(v, m, op, self.type, ztype)
        return self._writeback(out, types.cast(tv, ztype, out.type), tm,
                               mask, accum, desc)

    def apply_first(self, first, op, out=None, mask=None, accum=None,
                    desc=None):
        """Apply a binary operator with the first operand bound to a
        scalar."""
        return self._apply_bound(first, op, True, out, mask, accum, desc)

    def apply_second(self, op, second, out=None, mask=None, accum=None,
                     desc=None):
        """Apply a binary operator with the second operand bound to a
        scalar."""
        return self._apply_bound(second, op, False, out, mask, accum, desc)

    def _apply_bound(self, scalar, op, bind_first, out, mask, accum, desc):
        mask, accum, desc = self._get_args(mask, accum, desc)
        if isinstance(scalar, Scalar):
            scalar = scalar[0]
        ztype = op.ztype(self.type)
        if out is None:
            out = Matrix.sparse(ztype, self._nrows, self._ncols,
                                device=self._dev)
        if self._is_huge:
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
        """apply_first/apply_second on COO triples."""
        r, c, v = self._coo()
        dev = common_device(self, out, mask)
        vt = self.type.to_torch(v, dev)
        ztype = op.ztype(self.type)
        if op.positional is not None:
            rt = torch.as_tensor(r, device=dev)
            ct = torch.as_tensor(c, device=dev)
            z = op.apply(vt, vt, dict(i0=rt, j0=ct, i1=rt, j1=ct))
            z = z.to(ztype.torch_dtype)
        else:
            m = torch.ones(vt.shape, dtype=torch.bool, device=dev)
            z, _ = dk.apply_binary_bound(vt, m, self.type._coerce(scalar),
                                         op, self.type, ztype, bind_first)
        return self._coo_writeback(
            out, r, c, ztype.to_numpy(z).astype(out.type._numpy_t),
            mask, accum, desc)

    @_timed("Matrix.select")
    def select(self, op, thunk=None, out=None, mask=None, accum=None,
               desc=None):
        """Select elements matching a predicate.  `op` may be a SelectOp,
        a string (``>`` ``<`` ``>=`` ``<=`` ``!=`` ``==`` against the
        thunk, ``>0`` ``<0`` ``>=0`` ``<=0`` ``!=0`` ``==0`` against
        zero), or 'min'/'max'."""
        if out is None:
            out = Matrix.sparse(self.type, self.nrows, self.ncols,
                                device=self._dev)
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
        if op.name in ("TRIL", "TRIU", "DIAG", "OFFDIAG"):
            thunk = np.int64(thunk)  # positional offset, not a value
        else:
            thunk = np.asarray(self.type._coerce(thunk)).astype(
                self.type._numpy_t)
            if self.type._view:
                thunk = thunk.view({16: np.int16, 32: np.int32,
                                    64: np.int64}[self.type._bits])
        op = op.at_type(self.type)
        mask, accum, desc = self._get_args(mask, accum, desc)
        if self._is_huge:
            r, c, v = self._coo()
            if desc.inp0:
                r, c, v = ck.build(c, r, v, v.dtype)
            max_r = int(r[-1]) if len(r) else 0
            max_c = int(c.max()) if len(c) else 0
            dev = common_device(self, out, mask)
            if (v.dtype.kind in "biuf" and getattr(op, "fn", None)
                    is not None and dw.eligible(
                        len(r), 0, max_r, max_c, v.dtype, v.dtype)):
                burble("select: device sort engine (%d nnz)", len(r))
                r2, c2, v2 = dw.select(r, c, v, op.apply, thunk,
                                       device=dev)
                return self._coo_writeback(
                    out, r2, c2, v2.astype(out.type._numpy_t),
                    mask, accum, desc)
            keep = op.apply(torch.as_tensor(r, device=dev),
                            torch.as_tensor(c, device=dev),
                            self.type.to_torch(v, dev),
                            torch.as_tensor(thunk, device=dev))
            keep = keep.cpu().numpy()
            return self._coo_writeback(
                out, r[keep], c[keep], v[keep].astype(out.type._numpy_t),
                mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair(desc.inp0)
        tv, tm = dk.select(v, m, torch.as_tensor(thunk, device=v.device), op)
        return self._writeback(out, types.cast(tv, self.type, out.type), tm,
                               mask, accum, desc)

    def tril(self, offset=None):
        """Lower triangular selection."""
        from . import selectop

        return self.select(selectop.TRIL, thunk=offset)

    def triu(self, offset=None):
        """Upper triangular selection."""
        from . import selectop

        return self.select(selectop.TRIU, thunk=offset)

    def diag(self, offset=None):
        """Diagonal selection."""
        from . import selectop

        return self.select(selectop.DIAG, thunk=offset)

    def offdiag(self, offset=None):
        """Off-diagonal selection."""
        from . import selectop

        return self.select(selectop.OFFDIAG, thunk=offset)

    def nonzero(self):
        """Select the non-zero entries."""
        from . import selectop

        return self.select(selectop.NONZERO)

    def vector_diag(self, k=0, desc=None):
        """Diagonal `k` as a Vector (GxB_Vector_diag)."""
        from .vector import Vector

        if k >= 0:
            n = min(self._nrows, self._ncols - k)
        else:
            n = min(self._nrows + k, self._ncols)
        n = max(n, 0)
        out = Vector.sparse(self.type, n, device=self._dev)
        if self._is_huge:
            r, c, v = self._coo()
            sel = (c - r) == k
            idx = r[sel] if k >= 0 else c[sel]
            keep = idx < n
            return out._coo_writeback(out, idx[keep], v[sel][keep],
                                      None, None, Default)
        v, m = self._dense_pair()
        idx = torch.arange(n, device=v.device)
        if k >= 0:
            dv, dm = v[idx, idx + k], m[idx, idx + k]
        else:
            dv, dm = v[idx - k, idx], m[idx - k, idx]
        out._set_dense(dv, dm)
        return out

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------

    def _reduce_pair(self):
        """(vals, mask) tensors for reduction: the dense pair, or the COO
        value vector (every stored value present) for huge matrices."""
        if self._is_huge:
            _, _, v = self._coo()
            dev = self._device()
            if v.size:
                return (self.type.to_torch(v, dev),
                        torch.ones(v.size, dtype=torch.bool, device=dev))
            return (torch.zeros(1, dtype=self.type.torch_dtype, device=dev),
                    torch.zeros(1, dtype=torch.bool, device=dev))
        return self._dense_pair()

    def _reduce_to(self, mon, typ, accum):
        """The monoid's fold of every present value cast to `typ`, then
        the accumulator: a numpy scalar of typ."""
        v, m = self._reduce_pair()
        r = dk.reduce_all(types.cast(v, self.type, typ), m, mon, typ)
        return _reduce_accum(accum, typ.to_numpy(r), typ._numpy_t)

    def reduce_bool(self, mon=None, mask=None, accum=None, desc=None):
        """Reduce to a boolean with the given monoid (default LOR)."""
        if mon is None:
            mon = current_monoid.get(None) or types.BOOL.LOR_MONOID
        _, accum, desc = self._get_args(None, accum, desc)
        return bool(self._reduce_to(mon, types.BOOL, accum))

    def reduce_int(self, mon=None, mask=None, accum=None, desc=None):
        """Reduce to an int with the given monoid (default PLUS)."""
        if mon is None:
            mon = current_monoid.get(None) or types.INT64.PLUS_MONOID
        _, accum, desc = self._get_args(None, accum, desc)
        return int(self._reduce_to(mon, types.INT64, accum))

    def reduce_float(self, mon=None, mask=None, accum=None, desc=None):
        """Reduce to a float with the given monoid (default PLUS)."""
        if mon is None:
            mon = current_monoid.get(None) or self.type.PLUS_MONOID
        _, accum, desc = self._get_args(None, accum, desc)
        return float(self._reduce_to(mon, types.FP64, accum))

    def reduce(self, mon=None, accum=None, desc=None):
        """Type-generic reduce to a scalar of this matrix's type."""
        if mon is None:
            mon = current_monoid.get(None)
            if mon is None:
                mon = getattr(self.type,
                              self.type._default_addop().op + "_MONOID")
        _, accum, desc = self._get_args(None, accum, desc)
        npt = self.type._numpy_t
        return self.type._to_value(
            np.asarray(self._reduce_to(mon, self.type, accum)).astype(npt))

    @_timed("Matrix.reduce_vector")
    def reduce_vector(self, mon=None, out=None, cast=None, mask=None,
                      accum=None, desc=None):
        """Reduce rows to a Vector (or columns with desc=T0)."""
        from .vector import Vector

        mask, accum, desc = self._get_args(mask, accum, desc)
        typ = cast or self.type
        if mon is None:
            mon = current_monoid.get(None)
            if mon is None:
                mon = getattr(typ, typ._default_addop().op + "_MONOID")
        if out is None:
            out = Vector.sparse(typ, self._ncols if desc.inp0 else self._nrows,
                                device=self._dev)
        if self._is_huge:
            from .core import sparse as sk

            dev = common_device(self, out, mask)
            if out._fits_bitmap(out.size, out.type):
                rows, cols, vals = self._device_coo(dev)
                ids = cols if desc.inp0 else rows
                zt = np.dtype(out.type._numpy_t)
                tv, tm = sk.coo_segment_reduce(
                    ids, types.cast(vals, self.type, out.type), mon, zt,
                    out.size)
                return out._writeback(out, tv, tm, mask, accum, desc)
            # huge output vector: sparse-output compact segment reduce
            r, c, v = self._coo()
            ids = c if desc.inp0 else r
            uids, red = sk.coo_segment_reduce_compact(
                ids, v.astype(out.type._numpy_t), mon,
                np.dtype(out.type._numpy_t), dev)
            return out._coo_writeback(out, uids, red, mask, accum, desc)
        common_device(self, out, mask)
        v, m = self._dense_pair(desc.inp0)
        tv, tm = dk.reduce_axis(types.cast(v, self.type, typ), m, mon, 1,
                                typ)
        return out._writeback(out, types.cast(tv, typ, out.type), tm,
                              mask, accum, desc)

    # ------------------------------------------------------------------
    # matmul family
    # ------------------------------------------------------------------

    def _resolve_semiring(self, semiring, out_type):
        if semiring is None:
            semiring = current_semiring.get(None)
        if semiring is None:
            semiring = out_type._default_semiring()
        return semiring

    @_timed("Matrix.mxm")
    def mxm(self, other, semiring=None, cast=None, out=None, mask=None,
            accum=None, desc=None):
        """Matrix-matrix multiply with a semiring (``A @ B``).  A mask
        bounds the output pattern; `accum` folds into `out`; `desc=T0`
        multiplies the transpose; a `with` semiring block changes the
        operators of the enclosed `@`."""
        if semiring is None:
            semiring = current_semiring.get(None)
        mask, accum, desc = self._get_args(mask, accum, desc)
        anrows = self._ncols if desc.inp0 else self._nrows
        ancols = self._nrows if desc.inp0 else self._ncols
        bnrows = other._ncols if desc.inp1 else other._nrows
        bncols = other._nrows if desc.inp1 else other._ncols
        if ancols != bnrows:
            raise DimensionMismatch(f"mxm: {ancols} != {bnrows}")
        if out is None:
            if cast is not None:
                typ = cast
            elif semiring is not None:
                typ = semiring.ztype
            else:
                typ = promote(self.type, other.type)
            out = Matrix.sparse(typ, anrows, bncols, device=self._dev)
        if semiring is None:
            semiring = out.type._default_semiring()
        burble("mxm %s %sx%s @ %sx%s", semiring.name, anrows, ancols,
               bnrows, bncols)
        # known-diagonal operand: every dot product has a single term, so
        # mxm collapses to one element-wise broadcast
        if semiring.mul_op.positional is None:
            if other._diag_c:
                return self._mxm_diag(other, semiring, out, mask, accum,
                                      desc, diag_right=True)
            if self._diag_c:
                return other._mxm_diag(self, semiring, out, mask, accum,
                                       desc, diag_right=False)
        if self._is_huge or other._is_huge or out._is_huge:
            return self._sparse_mxm(other, semiring, out, mask, accum, desc)
        common_device(self, other, out, mask)
        av, am = self._dense_pair(desc.inp0)
        bv, bm = other._dense_pair(desc.inp1)
        zt = semiring.ztype
        tv, tm = dk.mxm(av, am, bv, bm, semiring, np.dtype(zt._numpy_t))
        return self._writeback(out, types.cast(tv, zt, out.type), tm, mask,
                               accum, desc)

    def _mxm_diag(self, diag, semiring, out, mask, accum, desc,
                  diag_right):
        """mxm against a known-diagonal operand (self is the data
        matrix): each dot product has exactly one term, so the add monoid
        never fires and the product is a broadcast of mul() over the data
        pattern restricted to the diagonal's present entries."""
        zt = out.type
        mul = at_type(semiring.mul_op, zt)
        transposed = desc.inp0 if diag_right else desc.inp1
        dev = common_device(self, diag, out, mask)
        if self._is_huge or out._is_huge or diag._is_huge:
            r, c, v = self._coo()
            if transposed:
                r, c, v = ck.build(c, r, v, v.dtype)
            di, _, dvals = diag._coo()
            key = c if diag_right else r
            pos = np.searchsorted(di, key)
            pos_c = np.minimum(pos, max(len(di) - 1, 0))
            found = (pos < len(di)) & (di[pos_c] == key) if len(di) \
                else np.zeros(len(key), bool)
            rv, cv_, vv = r[found], c[found], v[found]
            dv = dvals[pos_c[found]] if len(di) else dvals[:0]
            a1, a2 = (vv, dv) if diag_right else (dv, vv)
            prod = mul.apply(zt.to_torch(a1.astype(zt._numpy_t), dev),
                             zt.to_torch(a2.astype(zt._numpy_t), dev))
            prod = types.cast(prod, mul.ztype(zt), zt)
            return self._coo_writeback(out, rv, cv_, zt.to_numpy(prod),
                                       mask, accum, desc)
        av, am = self._dense_pair(transposed)
        ddv, ddm = diag._dense_pair()
        dvec = types.cast(torch.diagonal(ddv), diag.type, zt)
        dmask = torch.diagonal(ddm)
        a = types.cast(av, self.type, zt)
        if diag_right:
            z = mul.apply(a, dvec[None, :].expand_as(a))
            tm = am & dmask[None, :]
        else:
            z = mul.apply(dvec[:, None].expand_as(a), a)
            tm = dmask[:, None] & am
        z = types.cast(z, mul.ztype(zt), zt)
        tv = torch.where(tm, z, torch.zeros((), dtype=zt.torch_dtype,
                                            device=z.device))
        return self._writeback(out, tv, tm, mask, accum, desc)

    def _sparse_mxm(self, other, semiring, out, mask, accum, desc):
        """SpGEMM for huge matrices.  With a (non-complement) mask the
        output pattern is bounded by the mask and each result entry is one
        sparse dot product (core/spgemm.py: the masked SpGEMM kernels on
        the card); unmasked (or complement-masked) products go through
        core/gustavson.py (ESC's kernels on the card).  The sparse
        writeback then applies the full mask/accum/replace semantics."""
        from .core import spgemm as gk
        from .core import gustavson as gus

        dev = common_device(self, other, out, mask)
        ra, ca, va = self._coo()
        if desc.inp0:
            ra, ca, va = self._coo_T()
        rb, cb, vb = (other._coo_T() if desc.inp1 else other._coo())
        zt = np.dtype(semiring.ztype._numpy_t)
        if mask is not None and not desc.complement:
            mr, mc = self._mask_pair_set(mask, desc)
            # the transpose of the effective B: other itself when inp1
            # already transposed it
            bt_r, bt_c, bt_v = (other._coo() if desc.inp1
                                else other._coo_T())
            r, c, v = gk.masked_spgemm(ra, ca, va, bt_r, bt_c, bt_v,
                                       mr, mc, semiring, zt, device=dev)
        else:
            m_eff = self._ncols if desc.inp0 else self._nrows
            k_eff = self._nrows if desc.inp0 else self._ncols
            n_eff = other._nrows if desc.inp1 else other._ncols
            r, c, v = gus.spgemm(ra, ca, va, rb, cb, vb, semiring, zt,
                                 dims=(m_eff, k_eff, n_eff), device=dev)
        return self._coo_writeback(out, r, c,
                                   np.asarray(v).astype(out.type._numpy_t),
                                   mask, accum, desc)

    @_timed("Matrix.mxv")
    def mxv(self, other, semiring=None, cast=None, out=None, mask=None,
            accum=None, desc=None):
        """Matrix-vector multiply (``A @ v``); any registered semiring may
        be passed."""
        from .vector import Vector

        if semiring is None:
            semiring = current_semiring.get(None)
        mask, accum, desc = self._get_args(mask, accum, desc)
        anrows = self._ncols if desc.inp0 else self._nrows
        ancols = self._nrows if desc.inp0 else self._ncols
        if ancols != other.size:
            raise DimensionMismatch(f"mxv: {ancols} != {other.size}")
        if out is None:
            if cast is not None:
                typ = cast
            elif semiring is not None:
                typ = semiring.ztype
            else:
                typ = promote(self.type, other.type)
            out = Vector.sparse(typ, anrows, device=self._dev)
        if semiring is None:
            semiring = out.type._default_semiring()
        if self._fmt == "coo" and not self._fits_bitmap(
                self._nrows, self._ncols, self.type):
            return self._sparse_mxv(other, semiring, out, mask, accum, desc,
                                    transpose=desc.inp0)
        common_device(self, other, out, mask)
        av, am = self._dense_pair(desc.inp0)
        xv, xm = other._dense_pair()
        zt = semiring.ztype
        tv, tm = dk.mxm(av, am, xv[:, None], xm[:, None], semiring,
                        np.dtype(zt._numpy_t))
        return out._writeback(out, types.cast(tv[:, 0], zt, out.type),
                              tm[:, 0], mask, accum, desc)

    def _spmv_plan(self, transpose, device=None):
        """Slot-major csr8 SpMV plan (core/csr8.py), cached per
        (orientation, device)."""
        from .core.csr8 import Csr8Plan

        self._flush()  # before touching the cache: a flush resets it
        dev = self._device() if device is None else resolve_device(device)
        cache = self._cache()
        key = ("csr8", bool(transpose), str(dev))
        if key not in cache:
            r, c, v = self._coo()
            if transpose:
                r, c, v = ck.build(c, r, v, v.dtype)
                cache[key] = Csr8Plan(r, c, v, self._ncols, self._nrows,
                                      dev, self.type)
            else:
                cache[key] = Csr8Plan(r, c, v, self._nrows, self._ncols,
                                      dev, self.type)
        return cache[key]

    def _xspmv_plan(self, transpose, dtype, device=None, async_build=False):
        """Gather-free decode/permute/fold SpMV plan (core/xspmv.py) on
        `device`, cached per (orientation, dtype, device); the host plan
        is built once (or loaded from the disk cache) and shared.

        With ``async_build``, a cold plan (no memory or disk copy) is
        built in a daemon thread and None is returned at once: the caller
        runs a planless engine meanwhile and takes the plan once it has
        landed (its build is a compile-like cost, minutes at nnz >= 10^7
        on one core).  A build that failed is recorded under the cache's
        ("xerror", ...) key and not retried."""
        from .core.xspmv import XSpmvPlan

        self._flush()
        dev = self._device() if device is None else resolve_device(device)
        cache = self._cache()
        hkey = ("x", bool(transpose), np.dtype(dtype).str)
        key = hkey + (str(dev),)
        if key in cache:
            return cache[key]
        if hkey not in cache:
            r, c, v = self._coo()
            if transpose:
                r, c = c, r
                nr, nc = self._ncols, self._nrows
            else:
                nr, nc = self._nrows, self._ncols
            if not async_build:
                cache[hkey] = XSpmvPlan.build(r, c, v, nr, nc,
                                              np.dtype(dtype))
            else:
                pkey = ("xpath",) + hkey
                if pkey not in cache:  # hash once, not per call
                    cache[pkey] = XSpmvPlan.cache_path(r, c, v, nr, nc,
                                                       np.dtype(dtype))
                path = cache[pkey]
                if path is not None and os.path.exists(path):
                    cache[hkey] = XSpmvPlan.build(r, c, v, nr, nc,
                                                  np.dtype(dtype))
                else:
                    self._start_plan_build(cache, hkey, r, c, v, nr, nc,
                                           np.dtype(dtype))
                    return None
        cache[key] = cache[hkey].to(dev)
        return cache[key]

    @staticmethod
    def _start_plan_build(cache, hkey, r, c, v, nr, nc, dtype):
        """Build the host xspmv plan in a daemon thread into `cache` (the
        dict itself: if the matrix changes, its flush swaps in a fresh
        dict and the stale plan lands in the discarded one)."""
        import threading

        from .core.xspmv import XSpmvPlan

        bkey = ("xbuilding",) + hkey
        if bkey in cache or ("xerror",) + hkey in cache:
            return

        def _bg():
            try:
                cache[hkey] = XSpmvPlan.build(r, c, v, nr, nc, dtype)
            except Exception as e:  # recorded, read by the caller's tests
                cache[("xerror",) + hkey] = e
            finally:
                cache.pop(bkey, None)

        t = threading.Thread(target=_bg, daemon=True,
                             name="xspmv-plan-build")
        cache[bkey] = t
        t.start()

    def _sparse_mxv(self, other, semiring, out, mask, accum, desc,
                    transpose, flip_mul=False):
        """SpMV for huge matrices: the gather-free xspmv pipeline (the
        hand kernels on the card) for a dense x when its plan is warm (or
        forced), else the csr8 gather pyramid, else the COO segment
        reduce; a sparse x takes SpMSpV."""
        from .core import sparse as sk
        from .core import csr8 as pk
        from .core import xspmv as xs

        dev = common_device(self, other, out, mask)
        ztyp = semiring.ztype
        zt = np.dtype(ztyp._numpy_t)
        # push/pull: a sparse frontier (stored COO, or bitmap with few
        # present entries) takes the SpMSpV engine, O(frontier edges)
        x_sparse = (getattr(other, "_fmt", None) == "coo"
                    or (getattr(other, "_fmt", None) == "bitmap"
                        and other.nvals * 64 < other.size))
        if x_sparse:
            from .core.spmspv import spmspv

            fi, fx = other._coo()
            u, s, d, oids, vals = self._host_csr(not transpose)
            uids, red = spmspv(u, s, d, oids, vals, fi, fx, semiring, zt,
                               flip_mul=flip_mul, device=dev)
            return out._coo_writeback(out, uids,
                                      red.astype(out.type._numpy_t),
                                      mask, accum, desc)
        if getattr(other, "_fmt", None) == "iso" \
                and not other._fits_bitmap(other.size, other.type):
            # O(1) iso operand: y = row-reduce of mul(a_ij, c), no x
            # materialization at any size
            mul = at_type(semiring.mul_op, ztyp)
            if mul.positional is not None:
                raise InsufficientSpace(
                    "positional mul against huge iso vectors")
            r, c, v = self._coo()
            ids = c if transpose else r
            a1 = ztyp.to_torch(v.astype(zt), dev)
            a2 = torch.full_like(a1, ztyp.scalar(other._iso_v))
            if flip_mul:
                a1, a2 = a2, a1
            prod = types.cast(mul.apply(a1, a2), mul.ztype(ztyp), ztyp)
            uids, red = sk.coo_segment_reduce_compact(
                ids, ztyp.to_numpy(prod), semiring.add_monoid, zt, dev)
            return out._coo_writeback(out, uids,
                                      red.astype(out.type._numpy_t),
                                      mask, accum, desc)
        xv, xm = other._dense_pair()
        xv = types.cast(xv, other.type, ztyp)
        hkey = ("x", bool(transpose), zt.str)
        use_x = (config.spmv_engine != "csr8"
                 and other.nvals == other.size
                 and xs.supported(semiring, zt, self.nvals)
                 and (config.spmv_engine == "xspmv"
                      or (self._ell_c is not None and hkey in self._ell_c)))
        xplan = None
        if use_x:
            xplan = self._xspmv_plan(transpose, zt, device=dev)
        elif (config.spmv_plan_async and config.spmv_engine == "auto"
              and other.nvals == other.size
              and xs.supported(semiring, zt, self.nvals)):
            # start (or poll) the background plan build: repeated eager
            # SpMV loops move to xspmv once it has landed
            xplan = self._xspmv_plan(transpose, zt, device=dev,
                                     async_build=True)
        if xplan is not None:
            tv, tm = xs.xspmv(xplan, xv, semiring, zt, flip_mul=flip_mul)
        elif pk.plan_supported(semiring):
            tv, tm = pk.run_spmv_masked(self._spmv_plan(transpose, dev), xv,
                                        xm, semiring, zt, flip_mul=flip_mul)
        else:
            rows, cols, vals = self._device_coo(dev)
            ids_out, ids_in = (cols, rows) if transpose else (rows, cols)
            tv, tm = sk.coo_spmv(ids_out, ids_in,
                                 types.cast(vals, self.type, ztyp), xv, xm,
                                 semiring, zt, out.size, flip_mul=flip_mul)
        return out._writeback(out, types.cast(tv, ztyp, out.type), tm,
                              mask, accum, desc)

    def _host_csr(self, in_is_col):
        """Host CSR-style segments over the SpMV in-dimension: (unique
        in-ids, starts, degrees, out-ids, vals) with edges sorted by
        in-id.  Cached per orientation (the SpMSpV engine)."""
        self._flush()
        cache = self._cache()
        key = ("hcsr", bool(in_is_col))
        if key not in cache:
            r, c, v = self._coo()
            if in_is_col:
                ins, outs, vv = ck.build(c, r, v, v.dtype)
            else:
                ins, outs, vv = r, c, v
            u, s, d = np.unique(ins, return_index=True,
                                return_counts=True)
            cache[key] = (u, s, d, outs, vv)
        return cache[key]

    @property
    def _dev_coo_c(self):
        """The device COO triples `_device_coo` cached on this matrix's
        device, or None (the JAX package keeps them in a slot of this
        name; the port caches them per device in `_ell_c`)."""
        if self._ell_c is None or self._dev is None:
            return None
        return self._ell_c.get(("coo", str(self._dev)))

    def _device_coo(self, device=None):
        """Device copies of the canonical COO triples (cached per device;
        int32 indices when the dimensions allow)."""
        self._flush()
        dev = self._device() if device is None else resolve_device(device)
        key = ("coo", str(dev))
        cache = self._cache()
        if key not in cache:
            r, c, v = self._coo()
            idt = np.int32 if max(self._nrows, self._ncols) < 2**31 \
                else np.int64
            cache[key] = (as_tensor(r.astype(idt), dev),
                          as_tensor(c.astype(idt), dev),
                          self.type.to_torch(v, dev))
        return cache[key]

    def __matmul__(self, other):
        if isinstance(other, Matrix):
            return self.mxm(other)
        return self.mxv(other)

    def __imatmul__(self, other):
        return self.mxm(other, out=self)

    def __pow__(self, exponent):
        if exponent == 0:
            return self.__class__.identity(self.type, self.nrows,
                                           device=self._dev)
        if exponent == 1:
            return self
        result = self.dup()
        for _ in range(1, exponent):
            result.mxm(self, out=result)
        return result

    def kronpow(self, exponent):
        """Kronecker-power expansion (graph generation): each step
        squares the result, ``result = result.kronecker(result)``, as
        the JAX package's does."""
        if exponent == 0:
            return self.__class__.identity(self.type, self.nrows,
                                           device=self._dev)
        if exponent == 1:
            return self
        result = self.dup()
        for _ in range(1, exponent):
            result = result.kronecker(result)
        return result

    @_timed("Matrix.kronecker")
    def kronecker(self, other, op=None, cast=None, out=None, mask=None,
                  accum=None, desc=None):
        """Kronecker product with `op` (default TIMES): out[i*p + k,
        j*q + l] = op(A[i, j], B[k, l]) for B of shape (p, q).  The
        bitmap tier broadcasts `op` on the device (``dk.kronecker``); a
        huge operand or output takes the host triples
        (``coosem.kron``)."""
        mask, accum, desc = self._get_args(mask, accum, desc)
        typ = cast or promote(self.type, other.type)
        if op is None:
            op = current_binop.get(None) or typ.TIMES
        if isinstance(op, Semiring):
            op = op.mul_op
        if isinstance(op, Monoid):
            op = op.binaryop
        a_nr, a_nc = ((self._ncols, self._nrows) if desc.inp0
                      else (self._nrows, self._ncols))
        b_nr, b_nc = ((other._ncols, other._nrows) if desc.inp1
                      else (other._nrows, other._ncols))
        if out is None:
            out = Matrix.sparse(typ, a_nr * b_nr, a_nc * b_nc,
                                device=self._dev)
        if self._is_huge or other._is_huge or out._is_huge:
            common_device(self, other, out, mask)
            ra, ca, va = self._coo()
            if desc.inp0:
                ra, ca, va = ck.build(ca, ra, va, va.dtype)
            rb, cb, vb = other._coo()
            if desc.inp1:
                rb, cb, vb = ck.build(cb, rb, vb, vb.dtype)
            dt = out.type._numpy_t
            r, c, v = cs.kron(ra, ca, va.astype(dt), rb, cb, vb.astype(dt),
                              b_nr, b_nc, np_binop(op), dt)
            return self._coo_writeback(out, r, c, v, mask, accum, desc)
        common_device(self, other, out, mask)
        av, am = self._dense_pair(desc.inp0)
        bv, bm = other._dense_pair(desc.inp1)
        tv, tm = dk.kronecker(av, am, bv, bm, op, self.type, other.type,
                              out.type)
        return self._writeback(out, tv, tm, mask, accum, desc)

    # ------------------------------------------------------------------
    # extract / assign over GraphBLAS index sets (stop-inclusive slices,
    # lists, negative steps backwards)
    # ------------------------------------------------------------------

    def _resolve_index(self, idx, dim_size):
        """An index argument as a host numpy index vector."""
        return np.asarray(self._resolve_iset(idx, dim_size)
                          .indices(dim_size), np.int64)

    def _resolve_iset(self, idx, dim_size):
        """An index argument as an IndexSet with its size resolved."""
        if _is_int(idx):
            iset = _build_range(slice(idx, idx), dim_size - 1)
        else:
            iset = _build_range(idx, dim_size - 1)
        if iset.size is None:
            iset.size = dim_size
        return iset

    @_timed("Matrix.extract_matrix")
    def extract_matrix(self, row_index=None, col_index=None, out=None,
                       mask=None, accum=None, desc=None):
        """Extract a submatrix (GrB_Matrix_extract): slices are
        stop-inclusive, a negative step selects backwards, a list picks
        rows in its order (repeats allowed).  `desc=T0` extracts from
        the transpose."""
        ta = desc is not None and desc.inp0
        mask, accum, desc = self._get_args(mask, accum, desc)
        result_nrows = self.ncols if ta else self.nrows
        result_ncols = self.nrows if ta else self.ncols
        iset_r = self._resolve_iset(row_index, result_nrows)
        iset_c = self._resolve_iset(col_index, result_ncols)
        if out is None:
            out = self.__class__.sparse(self.type, iset_r.size, iset_c.size,
                                        device=self._dev)
        if self._is_huge or out._is_huge:
            r, c, v = self._coo()
            if ta:
                r, c, v = ck.build(c, r, v, v.dtype)
            er, ec, ev = cs.extract(r, c, v,
                                    cs.selector(iset_r, result_nrows),
                                    cs.selector(iset_c, result_ncols))
            return self._coo_writeback(out, er, ec,
                                       ev.astype(out.type._numpy_t),
                                       mask, accum, desc)
        dev = common_device(self, out, mask)
        I = torch.as_tensor(iset_r.indices(result_nrows), device=dev)
        J = torch.as_tensor(iset_c.indices(result_ncols), device=dev)
        v, m = self._dense_pair(ta)
        tv, tm = dk.gather2d(v, m, I, J)
        return self._writeback(out, types.cast(tv, self.type, out.type), tm,
                               mask, accum, desc)

    def extract_col(self, col_index, row_slice=None, out=None, mask=None,
                    accum=None, desc=None):
        """Extract a column (or part of it) as a Vector."""
        from .vector import Vector

        ta = desc is not None and desc.inp0
        dim = self.ncols if ta else self.nrows
        iset = self._resolve_iset(row_slice, dim)
        mask, accum, desc = self._get_args(mask, accum, desc)
        if out is None:
            out = Vector.sparse(self.type, iset.size, device=self._dev)
        if self._is_huge:
            r, c, v = self._coo()
            if ta:
                r, c, v = ck.build(c, r, v, v.dtype)
            sel = c == col_index
            rows, vals = r[sel], v[sel]
            ent, pos = cs.selector(iset, dim).select(rows)
            ti, tv = pos, vals[ent]
            order = np.argsort(ti, kind="stable")
            return out._coo_writeback(out, ti[order],
                                      tv[order].astype(out.type._numpy_t),
                                      mask, accum, desc)
        dev = common_device(self, out, mask)
        I = torch.as_tensor(iset.indices(dim), device=dev)
        v, m = self._dense_pair(ta)
        return out._writeback(
            out, types.cast(v[I, col_index], self.type, out.type),
            m[I, col_index], mask, accum, desc)

    def extract_row(self, row_index, col_slice=None, out=None, mask=None,
                    accum=None, desc=None):
        """Extract a row (or part of it) as a Vector: the column extract
        of the transpose."""
        desc2 = desc if desc is not None else Default
        flipped = desc2 & T0 if not desc2.inp0 else desc2
        return self.extract_col(row_index, col_slice, out, mask=mask,
                                accum=accum, desc=flipped)

    def _assign_line(self, line, value, iset, dim, mask, accum, desc,
                     is_col):
        """C(I, j) or C(i, J) <m> (accum)= x on the dense tensors: the
        line's entries where x (masked) is present take x (or
        accum(c, x) where both are present)."""
        self._flush()
        dev = common_device(self, value, mask)
        v, m = self._dense_pair()
        xv, xm = value._dense_pair()
        xv = types.cast(xv, value.type, self.type)
        idx = torch.as_tensor(iset.indices(dim), device=dev)
        at = (idx, line) if is_col else (line, idx)
        if mask is not None:
            mv, mm = mask._dense_pair()
            w = dk.effective_mask(mv, mm, desc.complement, desc.structural)
            if w.ndim == 2:
                w = w[:, line] if is_col else w[line, :]
            xm = xm & w[idx]
        cur_v, cur_m = v[at], m[at]
        new_v = torch.where(xm, xv, cur_v)
        if accum is not None:
            acc = at_type(accum, self.type).apply(cur_v, xv)
            new_v = torch.where(cur_m & xm, acc.to(v.dtype), new_v)
        new_m = xm if desc.replace else (cur_m | xm)
        v2, m2 = v.clone(), m.clone()
        v2[at] = new_v
        m2[at] = new_m
        self._set_dense(v2, m2)

    def assign_col(self, col_index, value, row_slice=None, mask=None,
                   accum=None, desc=None):
        """Assign a Vector to a column (or part of it)."""
        mask, accum, desc = self._get_args(mask, accum, desc)
        stop_val = self.ncols if desc.inp0 else self.nrows
        iset = self._resolve_iset(row_slice, stop_val)
        if iset.size != value.size:
            raise DimensionMismatch("assign_col length mismatch")
        if self._is_huge:
            return self._assign_line_sparse(value, iset, stop_val,
                                            col_index, mask, accum, desc,
                                            is_col=True)
        self._assign_line(col_index, value, iset, stop_val, mask, accum,
                          desc, is_col=True)

    def assign_row(self, row_index, value, col_slice=None, mask=None,
                   accum=None, desc=None):
        """Assign a Vector to a row (or part of it)."""
        mask, accum, desc = self._get_args(mask, accum, desc)
        iset = self._resolve_iset(col_slice, self.ncols)
        if iset.size != value.size:
            raise DimensionMismatch("assign_row length mismatch")
        if self._is_huge:
            return self._assign_line_sparse(value, iset, self.ncols,
                                            row_index, mask, accum, desc,
                                            is_col=False)
        self._assign_line(row_index, value, iset, self.ncols, mask, accum,
                          desc, is_col=False)

    def _assign_line_sparse(self, value, iset, dim, fixed_index, mask,
                            accum, desc, is_col):
        """COO-tier row/column assign: a one-wide assign_region along
        the fixed row (is_col=False) or column (is_col=True)."""
        self._flush()
        ti, tv = value._coo()
        cr, cc, cv = self._coo()
        mpr = mpc = None
        if mask is not None:
            if isinstance(mask, Matrix):
                mpr, mpc = self._mask_pair_set(mask, desc)
            else:
                # a vector mask lies along the assigned line: lift it
                # into C's coordinates for the region map
                mi, mv = mask._coo()
                ii, jj = ((mi, np.full_like(mi, fixed_index)) if is_col
                          else (np.full_like(mi, fixed_index), mi))
                mpr, mpc = cs.mask_pairs(ii, jj, mv, desc.structural)
        accum_fn = np_binop(accum) if accum is not None else None
        line_sel = cs.ArithSelector(fixed_index, 1, 1)
        span_sel = cs.selector(iset, dim)
        zero = np.zeros_like(ti)
        if is_col:
            args = (ti, zero, span_sel, line_sel)
        else:
            args = (zero, ti, line_sel, span_sel)
        nr, nc, nv = cs.assign_region(
            cr, cc, cv, args[0], args[1], tv.astype(self.type._numpy_t),
            args[2], args[3], mpr, mpc, accum_fn, desc.complement,
            desc.replace, self.type._numpy_t)
        self._set_coo(nr, nc, nv)

    def _region_writeback(self, I, J, tv, tm, mask, accum, desc):
        """C(I, J)<M> (accum)= T on the dense tensors, T of the region's
        shape: the mask is restricted to the region when it spans C."""
        v, m = self._dense_pair()
        sub_v, sub_m = dk.gather2d(v, m, I, J)
        mv, mm = self._region_mask(mask, I, J, desc)
        nv, nm = dk.writeback(sub_v, sub_m, tv, tm, mv, mm, accum=accum,
                              complement=desc.complement,
                              structural=desc.structural,
                              replace=desc.replace, typ=self.type)
        self._set_dense(*dk.scatter2d(v, m, I, J, nv, nm))

    def _region_mask(self, mask, I, J, desc):
        if mask is None:
            return None, None
        mv, mm = mask._dense_pair()
        if tuple(mv.shape) == self.shape:
            mv, mm = dk.gather2d(mv, mm, I, J)
        return mv, mm

    @_timed("Matrix.assign_matrix")
    def assign_matrix(self, value, rindex=None, cindex=None, mask=None,
                      accum=None, desc=None):
        """C(I, J)<M> (accum)= A (GrB_Matrix_assign): the whole matrix by
        default; the mask applies over C, restricted to the region."""
        mask, accum, desc = self._get_args(mask, accum, desc)
        iset_r = self._resolve_iset(rindex, self.nrows)
        iset_c = self._resolve_iset(cindex, self.ncols)
        if iset_r.size != value.nrows or iset_c.size != value.ncols:
            raise DimensionMismatch("assign shape mismatch")
        if self._is_huge or value._is_huge:
            self._flush()
            tr, tc, tv = value._coo()
            if desc.inp0:
                tr, tc, tv = ck.build(tc, tr, tv, tv.dtype)
            full = (iset_r.kind == IndexSet.ALL
                    and iset_c.kind == IndexSet.ALL
                    and (iset_r.size, iset_c.size) == self.shape)
            if full:
                self._coo_writeback(self, tr, tc,
                                    tv.astype(self.type._numpy_t),
                                    mask, accum, desc)
                return
            cr, cc, cv = self._coo()
            mpr, mpc = self._mask_pair_set(mask, desc)
            accum_fn = np_binop(accum) if accum is not None else None
            nr, nc, nv = cs.assign_region(
                cr, cc, cv, tr, tc, tv.astype(self.type._numpy_t),
                cs.selector(iset_r, self.nrows),
                cs.selector(iset_c, self.ncols),
                mpr, mpc, accum_fn, desc.complement, desc.replace,
                self.type._numpy_t)
            self._set_coo(nr, nc, nv)
            return
        I = iset_r.indices(self.nrows)
        J = iset_c.indices(self.ncols)
        self._flush()
        dev = common_device(self, value, mask)
        xv, xm = value._dense_pair(desc.inp0)
        xv = types.cast(xv, value.type, self.type)
        if (len(I), len(J)) == self.shape and \
                np.array_equal(I, np.arange(self.nrows)) and \
                np.array_equal(J, np.arange(self.ncols)):
            self._writeback(self, xv, xm, mask, accum, desc)
            return
        self._region_writeback(torch.as_tensor(I, device=dev),
                               torch.as_tensor(J, device=dev), xv, xm,
                               mask, accum, desc)

    assign = assign_matrix

    @_timed("Matrix.assign_scalar")
    def assign_scalar(self, value, row_slice=None, col_slice=None, mask=None,
                      accum=None, desc=None):
        """C(I, J)<M> (accum)= s: the whole matrix by default; with a
        mask only the mask's pattern is written."""
        mask, accum, desc = self._get_args(mask, accum, desc)
        iset_r = self._resolve_iset(row_slice, self.nrows)
        iset_c = self._resolve_iset(col_slice, self.ncols)
        if self._is_huge:
            return self._assign_scalar_sparse(value, iset_r, iset_c, mask,
                                              accum, desc)
        self._flush()
        dev = common_device(self, mask)
        s = self.type.scalar(self.type._coerce(value))
        tdt = self.type.torch_dtype
        if iset_r.kind == IndexSet.ALL and iset_c.kind == IndexSet.ALL:
            tv = torch.full(self.shape, s, dtype=tdt, device=dev)
            tm = torch.ones(self.shape, dtype=torch.bool, device=dev)
            self._writeback(self, tv, tm, mask, accum, desc)
            return
        I = torch.as_tensor(iset_r.indices(self.nrows), device=dev)
        J = torch.as_tensor(iset_c.indices(self.ncols), device=dev)
        shape = (len(I), len(J))
        self._region_writeback(
            I, J, torch.full(shape, s, dtype=tdt, device=dev),
            torch.ones(shape, dtype=torch.bool, device=dev), mask, accum,
            desc)

    def _assign_scalar_sparse(self, value, iset_r, iset_c, mask, accum,
                              desc):
        """Scalar assign on a huge matrix: a masked whole-matrix fill
        takes the mask's pattern (the ``Y[M] = 32`` idiom at any size);
        a bounded region materializes; an unbounded unmasked fill cannot
        be enumerated."""
        self._flush()
        val = self.type._coerce(value)
        full = (iset_r.kind == IndexSet.ALL and iset_c.kind == IndexSet.ALL)
        cells = iset_r.size * iset_c.size
        if full and mask is not None and not desc.complement:
            mpr, mpc = self._mask_pair_set(mask, desc)
            tv = np.full(len(mpr), val, self.type._numpy_t)
            self._coo_writeback(self, mpr, mpc, tv, mask, accum, desc)
            return
        if cells > self._SCALAR_FILL_BUDGET:
            raise InsufficientSpace(
                "unbounded scalar fill on a huge matrix requires a mask "
                "(the fill pattern cannot be enumerated)")
        I = np.repeat(np.arange(iset_r.size, dtype=np.int64), iset_c.size)
        J = np.tile(np.arange(iset_c.size, dtype=np.int64), iset_r.size)
        tv = np.full(len(I), val, self.type._numpy_t)
        cr, cc, cv = self._coo()
        mpr, mpc = self._mask_pair_set(mask, desc)
        accum_fn = np_binop(accum) if accum is not None else None
        nr, nc, nv = cs.assign_region(
            cr, cc, cv, I, J, tv,
            cs.selector(iset_r, self.nrows),
            cs.selector(iset_c, self.ncols),
            mpr, mpc, accum_fn, desc.complement, desc.replace,
            self.type._numpy_t)
        self._set_coo(nr, nc, nv)

    # ------------------------------------------------------------------
    # comparison operators
    # ------------------------------------------------------------------

    def _full(self):
        B = self.__class__.sparse(self.type, self.nrows, self.ncols,
                                  device=self._dev)
        B.assign_scalar(self.type.default_one)
        return self.eadd(B, self.type.FIRST)

    def _compare(self, other, op, strop):
        C = self.__class__.sparse(types.BOOL, self.nrows, self.ncols,
                                  device=self._dev)
        if _is_scalar(other):
            if op(other, 0):
                B = self.__class__.dup(self)
                B.assign_scalar(other)
                self.emult(B, strop, out=C)
                return C
            self.select(strop, other).apply(types.BOOL.ONE, out=C)
            return C
        if isinstance(other, Matrix):
            A = self._full()
            B = other._full()
            A.emult(B, strop, out=C)
            return C
        raise TypeError("Unknown matrix comparison type.")

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
    # arithmetic operator overloads
    # ------------------------------------------------------------------

    def __getattr__(self, name):
        """Look up operators as attributes: M.min_plus(N), M.plus_pair(v)."""
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            attr = getattr(self.type, name)
        except AttributeError:
            raise AttributeError(
                f"Matrix has no attribute or type operator {name}")
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
        if not isinstance(other, Matrix):
            return self.apply_second(op, other, out=out)
        return ewise(self, other, op, out=out)

    def _rarith(self, other, name, ewise):
        op = current_binop.get(getattr(self.type, name))
        if not isinstance(other, Matrix):
            return self.apply_first(other, op)
        return ewise(other, self, op)  # pragma: no cover

    def __add__(self, other):
        """eadd with PLUS; a scalar operand binds apply_second."""
        return self._arith(other, "PLUS", Matrix.eadd)

    def __radd__(self, other):
        return self._rarith(other, "PLUS", Matrix.eadd)

    def __iadd__(self, other):
        return self._arith(other, "PLUS", Matrix.eadd, out=self)

    def __sub__(self, other):
        return self._arith(other, "MINUS", Matrix.eadd)

    def __rsub__(self, other):
        return self._rarith(other, "MINUS", Matrix.eadd)

    def __isub__(self, other):
        return self._arith(other, "MINUS", Matrix.eadd, out=self)

    def __mul__(self, other):
        """emult with TIMES; a scalar operand binds apply_second."""
        return self._arith(other, "TIMES", Matrix.emult)

    def __rmul__(self, other):
        return self._rarith(other, "TIMES", Matrix.emult)

    def __imul__(self, other):
        return self._arith(other, "TIMES", Matrix.emult, out=self)

    def __truediv__(self, other):
        return self._arith(other, "DIV", Matrix.emult)

    def __rtruediv__(self, other):
        return self._rarith(other, "DIV", Matrix.emult)

    def __itruediv__(self, other):
        return self._arith(other, "DIV", Matrix.emult, out=self)

    def __invert__(self):
        """Multiplicative inverse of every element."""
        return self.apply(self.type.MINV)

    def __neg__(self):
        """Additive inverse of every element."""
        return self.apply(self.type.AINV)

    def __abs__(self):
        """Absolute value of every element."""
        return self.apply(self.type.ABS)

    # ------------------------------------------------------------------
    # graph helpers
    # ------------------------------------------------------------------

    def shard(self, mesh, balance=True):
        """Shard this matrix over a ``torch.distributed`` ``DeviceMesh``
        with dimensions ("i", "j") (``parallel.make_mesh``); returns a
        :class:`~.parallel.dist.DistMatrix` whose mxv/pagerank/
        triangle_count run on each rank's tile with collectives over the
        mesh (the distribution tier).  Every rank calls it with the same
        matrix (SPMD).

        ``balance`` relabels vertices by a fixed random permutation so
        power-law hubs spread across tiles (padded-tile executors
        otherwise run at the max-tile load); outputs are mapped back to
        the original ids transparently.

        One card runs it on a (1, 1) mesh over NCCL; the CPU tests
        validate it on a 2 x 2 mesh of four gloo ranks.
        """
        from .parallel.dist import DistMatrix

        return DistMatrix(self, mesh, balance=balance)

    def out_degree(self, typ=types.UINT64, out=None):
        """Vector of out-degrees (default UINT64)."""
        from .vector import Vector

        return self.cast(typ).plus_pair(
            Vector.iso(1, self.nrows, device=self._dev), out=out)

    def gini(self, typ=types.FP64):
        """Gini coefficient of the out-degree distribution."""
        arr = np.sort(self.out_degree(typ).npV)
        n = arr.shape[0]
        index = np.arange(1, n + 1)
        return float((np.sum((2 * index - n - 1) * arr))
                     / (n * np.sum(arr)))


def _random_value_fn(typ):
    """Value-draw function per type, matching the JAX package's
    stdlib-random usage so seeded results agree."""
    if typ is types.BOOL:
        return partial(_stdlib_random.randint, 0, 1)
    if typ is types.UINT8:
        return partial(_stdlib_random.randint, 0, (2**8) - 1)
    if typ is types.UINT16:
        return partial(_stdlib_random.randint, 0, (2**16) - 1)
    if typ is types.UINT32:
        return partial(_stdlib_random.randint, 0, (2**32) - 1)
    if typ is types.UINT64:
        return partial(_stdlib_random.randint, 0, (2**64) - 1)
    if typ is types.INT8:
        return partial(_stdlib_random.randint, (-(2**7)) + 1, (2**7) - 1)
    if typ is types.INT16:
        return partial(_stdlib_random.randint, (-(2**15)) + 1, (2**15) - 1)
    if typ is types.INT32:
        return partial(_stdlib_random.randint, (-(2**31)) + 1, (2**31) - 1)
    if typ is types.INT64:
        return partial(_stdlib_random.randint, (-(2**63)) + 1, (2**63) - 1)
    if typ in (types.FP32, types.FP64):
        return _stdlib_random.random
    if typ in (types.FC32, types.FC64):
        return lambda: complex(_stdlib_random.random(),
                               _stdlib_random.random())
    raise TypeError(f"no random generator for {typ}")
