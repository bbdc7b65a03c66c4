"""Binary checkpoint format (.npz): the canonical COO triples and their
metadata in a portable numpy archive.

The JAX package's format (``pygraphblas_tpu/io/binfile.py``): the same
magic, type name and fields, so that a file either package writes loads
in the other.
"""

from pathlib import Path

import numpy as np

from .. import types

_MAGIC = "pygraphblas_tpu-v1"


def binwrite(M, filename, comments="", opener=Path.open):
    r, c, v = M._coo()
    with open(filename, "wb") as fh:
        np.savez_compressed(
            fh,
            magic=np.asarray(_MAGIC),
            comments=np.asarray(comments),
            typ=np.asarray(M.type.__name__),
            nrows=np.asarray(M.nrows, np.int64),
            ncols=np.asarray(M.ncols, np.int64),
            rows=r,
            cols=c,
            vals=v,
        )


def binread(cls, bin_file, opener=Path.open, device=None):
    with open(bin_file, "rb") as fh:
        data = np.load(fh, allow_pickle=False)
        if str(data["magic"]) != _MAGIC:
            raise ValueError("not a pygraphblas_tpu binary file")
        typ = getattr(types, str(data["typ"]))
        M = cls.sparse(typ, int(data["nrows"]), int(data["ncols"]),
                       device=device)
        M._build(data["rows"], data["cols"], data["vals"])
        return M
