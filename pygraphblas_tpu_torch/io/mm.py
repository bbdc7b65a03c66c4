"""MatrixMarket coordinate-format reader and writer (the JAX package's
``io/mm.py``): file paths go through the native parser
(``io/native.py``) when a C++ compiler is present, file-like objects
through the Python reader.  A bit view's values (UINT16/32/64) are
written as their unsigned values."""

import numpy as np

from .. import types


def _open(f, mode="r"):
    if hasattr(f, "read") or hasattr(f, "write"):
        return f, False
    return open(f, mode), True


def read_mm(mm_file):
    """Parse a MatrixMarket file.

    Returns (I, J, V, nrows, ncols, Type).  File paths go through the
    native C++ parser when a compiler is present to build it
    (csrc/fastio.cpp; a failed build raises); file-like objects, paths
    without a compiler, and the files the native parser leaves to it
    (complex, hermitian, an integer value that is not an int64 literal)
    through the Python reader.
    """
    if isinstance(mm_file, (str, bytes)) or hasattr(mm_file, "__fspath__"):
        from . import native

        parsed = native.parse_mm_native(mm_file) if native.available() \
            else None
        if parsed is not None:
            rows, cols, vals, nrows, ncols, field = parsed
            typ = {"p": types.BOOL, "i": types.INT64,
                   "r": types.FP64}[field]
            return rows, cols, vals.astype(typ._numpy_t), nrows, ncols, typ
    fh, should_close = _open(mm_file)
    try:
        header = fh.readline()
        if isinstance(header, bytes):  # pragma: no cover
            raise TypeError("open MatrixMarket files in text mode")
        parts = header.strip().split()
        if len(parts) < 5 or not parts[0].startswith("%%MatrixMarket"):
            raise ValueError(f"bad MatrixMarket header: {header!r}")
        _, obj, fmt, field, symmetry = parts[:5]
        if obj.lower() != "matrix" or fmt.lower() != "coordinate":
            raise ValueError("only coordinate matrices supported")
        field = field.lower()
        symmetry = symmetry.lower()
        line = fh.readline()
        while line.startswith("%"):
            line = fh.readline()
        nrows, ncols, nnz = map(int, line.split())
        I = np.empty(nnz, np.int64)
        J = np.empty(nnz, np.int64)
        if field == "pattern":
            typ = types.BOOL
            V = np.ones(nnz, np.bool_)
        elif field == "integer":
            typ = types.INT64
            V = np.empty(nnz, np.int64)
        elif field == "complex":
            typ = types.FC64
            V = np.empty(nnz, np.complex128)
        else:
            typ = types.FP64
            V = np.empty(nnz, np.float64)
        for k in range(nnz):
            parts = fh.readline().split()
            I[k] = int(parts[0]) - 1
            J[k] = int(parts[1]) - 1
            if field == "pattern":
                pass
            elif field == "integer":
                V[k] = int(parts[2])
            elif field == "complex":
                V[k] = complex(float(parts[2]), float(parts[3]))
            else:
                V[k] = float(parts[2])
        if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
            off = I != J
            I2, J2 = J[off], I[off]
            V2 = V[off]
            if symmetry == "skew-symmetric":
                V2 = -V2
            elif symmetry == "hermitian":
                V2 = np.conj(V2)
            I = np.concatenate([I, I2])
            J = np.concatenate([J, J2])
            V = np.concatenate([V, V2])
        return I, J, V, nrows, ncols, typ
    finally:
        if should_close:
            fh.close()


def write_mm(M, fileobj):
    """Write a Matrix in MatrixMarket coordinate format."""
    fh, should_close = _open(fileobj, "w")
    try:
        kind = np.dtype(M.type._numpy_t).kind
        field = {"b": "pattern", "i": "integer", "u": "integer",
                 "f": "real", "c": "complex"}[kind]
        fh.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        r, c, v = M._coo()
        fh.write(f"{M.nrows} {M.ncols} {len(r)}\n")
        for i, j, x in zip(r, c, v):
            if field == "pattern":
                fh.write(f"{i + 1} {j + 1}\n")
            elif field == "complex":
                fh.write(f"{i + 1} {j + 1} {x.real} {x.imag}\n")
            else:
                fh.write(f"{i + 1} {j + 1} {x}\n")
    finally:
        if should_close:
            fh.close()
