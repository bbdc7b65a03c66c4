"""Semirings for the xspmv engine: an add monoid (fold op + identity)
and a mul op, both named as in ``pygraphblas_tpu/core/xspmv.py``
(``_ADDS`` / ``_MULS``).

Each op has a plain PyTorch closure (the kernels' plain versions use
these) and an op code (the CUDA kernels switch on it; the codes must
match ``csrc/ops.cuh``)."""

import numpy as np
import torch

# add monoids: name -> (fold closure, kernel op code)
ADDS = {
    "PLUS": (lambda a, b: a + b, 0),
    "MIN": (torch.minimum, 1),
    "MAX": (torch.maximum, 2),
    "TIMES": (lambda a, b: a * b, 3),
}


def _div(a, b):
    if a.dtype.is_floating_point:
        return a / b
    # integer division truncates toward zero; x / 0 -> 0
    z = b == 0
    return torch.where(z, torch.zeros_like(a),
                       torch.div(a, torch.where(z, torch.ones_like(b), b),
                                 rounding_mode="trunc"))


# mul ops: name -> (closure mul(a=matrix value, b=x value), op code)
MULS = {
    "TIMES": (lambda a, b: a * b, 0),
    "PLUS": (lambda a, b: a + b, 1),
    "MINUS": (lambda a, b: a - b, 2),
    "RMINUS": (lambda a, b: b - a, 3),
    "DIV": (_div, 4),
    "RDIV": (lambda a, b: _div(b, a), 5),
    "FIRST": (lambda a, b: a, 6),
    "SECOND": (lambda a, b: b, 7),
    "PAIR": (lambda a, b: torch.ones_like(a), 8),
    "MIN": (torch.minimum, 9),
    "MAX": (torch.maximum, 10),
}

# the same op with its operands swapped (vxm's flip_mul)
FLIPPED = {"MINUS": "RMINUS", "RMINUS": "MINUS", "DIV": "RDIV",
           "RDIV": "DIV", "FIRST": "SECOND", "SECOND": "FIRST"}


def identity(add, dtype):
    """Identity of the add monoid `add` as a numpy scalar of `dtype`."""
    dt = np.dtype(dtype)
    if add == "PLUS":
        return dt.type(0)
    if add == "TIMES":
        return dt.type(1)
    big = np.inf if dt.kind == "f" else np.iinfo(dt).max
    small = -np.inf if dt.kind == "f" else np.iinfo(dt).min
    if add == "MIN":
        return dt.type(big)
    if add == "MAX":
        return dt.type(small)
    raise KeyError(add)


class Semiring:
    """``add`` names the add monoid, ``mul`` the multiply."""

    __slots__ = ("add", "mul", "name")

    def __init__(self, add, mul):
        if add not in ADDS or mul not in MULS:
            raise KeyError(f"{add}_{mul}")
        self.add, self.mul = add, mul
        self.name = f"{add}_{mul}"

    def identity(self, dtype):
        return identity(self.add, dtype)

    def __repr__(self):
        return f"Semiring({self.name})"
