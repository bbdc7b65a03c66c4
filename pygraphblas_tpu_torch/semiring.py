"""Semirings: an additive monoid paired with a multiplicative binary op.

Every built-in semiring is generated from the family tables in
``ops/table.py`` (the JAX package's ``semiring.py``): a Semiring is a
lightweight pair (``add_monoid``, ``mul_op``), named
``{pls}_{mul}_{type}`` and attached to its type (``FP32.PLUS_TIMES``).
The CUDA kernels switch on op codes derived from the ops' names
(``_kernels.fold_code``, ``_kernels.mul_code``).  ``Semiring(A, B)`` is
the product ``A.vxm(B)``, ``A.mxv(B)`` or ``A.mxm(B)`` by the operands'
kinds.
"""

import contextvars
import sys

from . import binaryop as binaryop_module
from . import monoid as monoid_module
from . import types
from .ops import table

current_semiring = contextvars.ContextVar("current_semiring")

__all__ = ["Semiring", "current_semiring"]

# the same op with its operands swapped (vxm's flip of the multiply)
FLIPPED = {"MINUS": "RMINUS", "RMINUS": "MINUS", "DIV": "RDIV",
           "RDIV": "DIV", "FIRST": "SECOND", "SECOND": "FIRST"}


class Semiring:
    """A GraphBLAS semiring."""

    __slots__ = ("name", "pls", "mul", "type", "type_cls", "add_monoid",
                 "mul_op", "_ztype_rule", "token")

    def __init__(self, pls, mul, typ, add=None, mul_op=None, ztype="T",
                 attach=True, type_cls=None):
        self.pls = pls
        self.mul = mul
        self.type = typ
        self.type_cls = type_cls if type_cls is not None else \
            getattr(types, typ, None)
        self.name = "_".join((pls, mul, typ))
        self.token = None
        self._ztype_rule = ztype
        if add is None:
            z = "BOOL" if ztype == "BOOL" else typ
            add = getattr(monoid_module, "_".join((pls, z, "monoid")))
        self.add_monoid = add
        if mul_op is None:
            mul_op = getattr(binaryop_module, "_".join((mul, typ)))
        self.mul_op = mul_op
        if attach:
            cls = getattr(types, typ, None)
            if cls is not None:
                nm = pls + "_" + mul
                setattr(cls, nm, self)
                setattr(cls, nm.lower(), self)

    def __repr__(self):
        return f"<Semiring {self.name}>"

    def __call__(self, A, B, *args, **kwargs):
        from .vector import Vector

        if isinstance(A, Vector):
            op = A.vxm
        elif isinstance(B, Vector):
            op = A.mxv
        else:
            op = A.mxm
        return op(B, self, *args, **kwargs)

    def __enter__(self):
        self.token = current_semiring.set(self)
        return self

    def __exit__(self, exception_type, exception_value, traceback):
        current_semiring.reset(self.token)
        return False

    def get_op(self):
        return self

    @property
    def ztype(self):
        """Result Type of this semiring (via the mul op's output domain)."""
        if self._ztype_rule == "BOOL":
            return types.BOOL
        return self.mul_op.ztype(self.type_cls)


def ops_at(semiring, typ):
    """The semiring's (add monoid, mul op) at Type `typ`: the built-in
    ops of the same names on `typ`, as the JAX package's closures take
    the dtype of the values they are given (an engine computes products
    at its output type); a user op, a positional one, or a name `typ`
    lacks, stays as it is."""
    mul = semiring.mul_op
    if mul.builtin and mul.positional is None:
        mul = getattr(binaryop_module, f"{mul.op}_{typ.__name__}", mul)
    add = semiring.add_monoid
    if add.binaryop.builtin:
        add = getattr(monoid_module, f"{add.op}_{typ.__name__}_monoid", add)
    return add, mul


def build_semirings(__pdoc__=None):
    this = sys.modules[__name__]
    for fam in table.SEMIRING_FAMILIES:
        for typ in fam["types"]:
            for pls in fam["adds"]:
                for mul in fam["muls"]:
                    # positional ops exist only as INT32/INT64 operators
                    bin_name = "_".join((mul, typ))
                    if not hasattr(binaryop_module, bin_name):
                        continue
                    r = Semiring(pls, mul, typ, ztype=fam["ztype"])
                    setattr(this, r.name, r)
                    if __pdoc__ is not None:
                        __pdoc__[f"{typ}.{pls}_{mul}"] = \
                            f"Semiring {typ}.{pls}_{mul}"
