"""Monoids: associative, commutative binary operators with an identity.

Built-ins generated from ``ops/table.py`` (the JAX package's
``monoid.py``).  ``Monoid(A, B)`` is the element-wise add
``A.eadd(B, monoid)``.
"""

__all__ = ["Monoid", "current_monoid"]

import contextvars
import sys

import numpy as np

from . import binaryop as binaryop_module
from . import types
from .ops import table

current_monoid = contextvars.ContextVar("current_monoid")


class Monoid:
    """A monoid: a BinaryOp plus an identity element."""

    __slots__ = ("name", "op", "type", "type_name", "binaryop",
                 "_identity_fn", "_identity", "token")

    def __init__(self, op, typ, op_obj=None, identity_fn=None, op_name=None,
                 identity=None, attach=True):
        # `op` is the family name (e.g. "PLUS"); the binary semantics may
        # differ (the BOOL "EQ" monoid uses LXNOR)
        self.op = op
        self.type = typ
        self.type_name = typ
        if op_obj is None:
            op_obj = getattr(binaryop_module, (op_name or op) + "_" + typ)
        self.binaryop = op_obj
        self._identity_fn = identity_fn
        self._identity = identity
        self.name = "_".join((op, typ, "monoid"))
        self.token = None
        if attach:
            cls = getattr(types, typ, None)
            if cls is not None:
                setattr(cls, op + "_MONOID", self)
                setattr(cls, op.lower() + "_monoid", self)

    def __repr__(self):
        return f"<Monoid {self.name}>"

    def __enter__(self):
        self.token = current_monoid.set(self)
        return self

    def __exit__(self, *errors):
        current_monoid.reset(self.token)
        return False

    def __call__(self, A, B, *args, **kwargs):
        return A.eadd(B, self, *args, **kwargs)

    def get_op(self):
        return self

    def identity(self, dtype):
        """Identity value as a numpy scalar of the given numpy dtype."""
        if self._identity is not None:
            return np.dtype(dtype).type(self._identity)
        return self._identity_fn(np.dtype(dtype))

    def apply(self, x, y, pos=None):
        return self.binaryop.apply(x, y, pos)


def build_monoids(__pdoc__=None):
    this = sys.modules[__name__]
    for name, (bin_name, id_fn, typs) in table.MONOIDS.items():
        for typ in typs:
            m = Monoid(name, typ, identity_fn=id_fn, op_name=bin_name)
            setattr(this, m.name, m)
            if m.name not in __all__:
                __all__.append(m.name)
            if __pdoc__ is not None:
                __pdoc__[f"{typ}.{name}_MONOID"] = \
                    f"Monoid {typ}.{name}_MONOID"
    for name, (bin_name, id_fn) in table.BOOL_MONOIDS.items():
        m = Monoid(name, "BOOL", identity_fn=id_fn, op_name=bin_name)
        setattr(this, m.name, m)
        if m.name not in __all__:
            __all__.append(m.name)
        if __pdoc__ is not None:
            __pdoc__[f"BOOL.{name}_MONOID"] = f"Monoid BOOL.{name}_MONOID"
