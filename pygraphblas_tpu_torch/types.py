"""GraphBLAS types at the size the port needs so far: FP32 and INT32,
each with its numpy and torch dtype and its semirings as attributes
(``FP32.PLUS_SECOND``), built from the ``ADDS`` x ``MULS`` table."""

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


FP32 = Type("FP32", np.float32, torch.float32)
INT32 = Type("INT32", np.int32, torch.int32)

_BY_NUMPY = {FP32.numpy_dtype: FP32, INT32.numpy_dtype: INT32}


def torch_dtype(dtype):
    """numpy dtype -> torch dtype for the types the port supports."""
    return _BY_NUMPY[np.dtype(dtype)].torch_dtype
