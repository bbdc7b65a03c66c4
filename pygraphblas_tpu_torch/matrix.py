"""Sparse matrix, at the size the port needs so far: host COO triples,
device copies per device, and the cached xspmv plans.

Counterpart of the COO side of ``pygraphblas_tpu/matrix.py``
(``_build``, ``_coo``, ``_device_coo``, ``_xspmv_plan``)."""

import numpy as np

from ._device import as_tensor, resolve_device


class Matrix:
    __slots__ = ("type", "_nrows", "_ncols", "_rows_h", "_cols_h",
                 "_vals_h", "_ell_c")

    def __init__(self, typ, nrows, ncols):
        self.type = typ
        self._nrows, self._ncols = int(nrows), int(ncols)
        self._rows_h = np.zeros(0, np.int64)
        self._cols_h = np.zeros(0, np.int64)
        self._vals_h = np.zeros(0, typ.numpy_dtype)
        self._ell_c = None       # per-matrix cache: plans, degrees, COO

    @classmethod
    def sparse(cls, typ, nrows, ncols):
        return cls(typ, nrows, ncols)

    def _build(self, I, J, V):
        """Bulk-build from COO triples (later duplicates win)."""
        I = np.asarray(I, np.int64)
        J = np.asarray(J, np.int64)
        V = np.asarray(V, self.type.numpy_dtype)
        if len(I) and (I.min() < 0 or J.min() < 0 or I.max() >= self._nrows
                       or J.max() >= self._ncols):
            raise IndexError("index out of bounds in build")
        if len(I) > 1:
            order = np.lexsort((J, I))          # stable, row-major
            I, J, V = I[order], J[order], V[order]
            last = np.empty(len(I), bool)
            last[:-1] = (I[:-1] != I[1:]) | (J[:-1] != J[1:])
            last[-1] = True
            I, J, V = I[last], J[last], V[last]
        self._rows_h, self._cols_h, self._vals_h = I, J, V
        self._ell_c = None

    def _coo(self):
        """Host canonical COO triples (rows, cols, vals)."""
        return self._rows_h, self._cols_h, self._vals_h

    @property
    def nrows(self):
        return self._nrows

    @property
    def ncols(self):
        return self._ncols

    @property
    def nvals(self):
        return len(self._rows_h)

    def _cache(self):
        if self._ell_c is None:
            self._ell_c = {}
        return self._ell_c

    def _device_coo(self, device=None):
        """Device copies of the COO triples (cached per device; int32
        indices when the dimensions allow)."""
        dev = resolve_device(device)
        key = ("coo", str(dev))
        cache = self._cache()
        if key not in cache:
            idt = np.int32 if max(self._nrows, self._ncols) < 2**31 \
                else np.int64
            cache[key] = tuple(
                as_tensor(a, dev) for a in (self._rows_h.astype(idt),
                          self._cols_h.astype(idt), self._vals_h))
        return cache[key]

    def _xspmv_plan(self, transpose, dtype, device=None):
        """Gather-free decode/permute/fold SpMV plan (core/xspmv.py) on
        `device`, cached per (orientation, dtype, device).  The host plan
        is built once (or loaded from the disk cache) and shared."""
        from .core.xspmv import XSpmvPlan

        dev = resolve_device(device)
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
            cache[hkey] = XSpmvPlan.build(r, c, v, nr, nc, np.dtype(dtype))
        cache[key] = cache[hkey].to(dev)
        return cache[key]
