"""GraphBLAS types at the size the port needs so far: BOOL, INT32,
INT64 and FP32, each with its numpy and torch dtype and its semirings as
attributes (``FP32.PLUS_SECOND``), built from the ``ADDS`` x ``MULS``
table.  The CUDA kernels take 4-byte values only (float32, int32): a
BOOL matrix runs through a float32 plan (its values cast), and INT64
holds results such as BFS levels."""

import numpy as np
import torch

from .semiring import ADDS, MULS, Semiring


class Type:
    def __init__(self, name, numpy_dtype, torch_dtype):
        self.name = name
        self.numpy_dtype = np.dtype(numpy_dtype)
        self.torch_dtype = torch_dtype
        for add in ADDS:
            for mul in MULS:
                setattr(self, f"{add}_{mul}", Semiring(add, mul))

    def __repr__(self):
        return self.name


BOOL = Type("BOOL", np.bool_, torch.bool)
INT32 = Type("INT32", np.int32, torch.int32)
INT64 = Type("INT64", np.int64, torch.int64)
FP32 = Type("FP32", np.float32, torch.float32)

_BY_NUMPY = {t.numpy_dtype: t for t in (BOOL, INT32, INT64, FP32)}


def torch_dtype(dtype):
    """numpy dtype -> torch dtype for the types the port supports."""
    return _BY_NUMPY[np.dtype(dtype)].torch_dtype
