"""Unary operators.

Built-ins generated from ``ops/table.py`` (the JAX package's
``unaryop.py``); user ops via the :func:`unary_op` decorator (a plain
Python function over tensors).  ``op(A)`` is ``A.apply(op)``; the
positional ops (POSITIONI ...) read the entries' coordinates there.
"""

__all__ = ["UnaryOp", "unary_op", "at_type"]

import sys

from . import _unsigned, types
from .ops import table


class UnaryOp:
    """A GraphBLAS unary operator z = f(x)."""

    __slots__ = ("name", "op", "type_name", "fn", "ztype_rule",
                 "positional", "builtin")

    def __init__(self, name, typ, fn=None, ztype="T", positional=None,
                 attach=True, builtin=False):
        self.op = name
        self.type_name = typ
        self.fn = fn
        self.ztype_rule = ztype
        self.positional = positional
        self.builtin = builtin
        self.name = "_".join((name, typ))
        if attach:
            cls = getattr(types, typ, None)
            if cls is not None:
                setattr(cls, name, self)
                setattr(cls, name.lower(), self)

    @property
    def type_cls(self):
        return getattr(types, self.type_name, None)

    def __repr__(self):
        return f"<UnaryOp {self.name}>"

    def __call__(self, A, *args, **kwargs):
        return A.apply(self, *args, **kwargs)

    def get_op(self):
        return self

    def ztype(self, input_type):
        if self.ztype_rule == "BOOL":
            return types.BOOL
        if self.ztype_rule == "REAL":
            return types.FP32 if input_type == types.FC32 else types.FP64
        if self.ztype_rule == "ABSZ":
            if input_type == types.FC32:
                return types.FP32
            if input_type == types.FC64:
                return types.FP64
            return input_type
        if self.positional is not None:
            return getattr(types, self.type_name)
        return input_type

    def apply(self, x, pos=None):
        """The operator on a tensor of its type's held dtype; a user op
        at UINT16, UINT32 or UINT64 gets the unsigned values, as the JAX
        package's does (``_unsigned.call``)."""
        if self.positional is not None:
            key, off = self.positional
            return pos[key] + off
        if self.builtin:
            return self.fn(x, self.type_cls)
        return _unsigned.call(self.fn, self.type_cls, x)


def at_type(op, typ):
    """The built-in unary op of `op`'s name at Type `typ` (as
    ``binaryop.at_type``): `op` itself for a user or positional op, or a
    name `typ` lacks."""
    if not getattr(op, "builtin", False) or op.positional is not None:
        return op
    return getattr(sys.modules[__name__], f"{op.op}_{typ.__name__}", op)


def build_unaryops(__pdoc__=None):
    this = sys.modules[__name__]
    for op_name, spec in table.UNARY.items():
        for typ in spec["types"]:
            r = UnaryOp(op_name, typ, fn=spec["fn"], ztype=spec["ztype"],
                        positional=spec.get("positional"), builtin=True)
            setattr(this, r.name, r)
            if __pdoc__ is not None:
                __pdoc__[f"{typ}.{op_name}"] = f"UnaryOp {typ}.{op_name}"


def unary_op(arg_type):
    """Decorator turning a Python function over tensors into a
    UnaryOp.

    >>> from pygraphblas_tpu_torch import Matrix, unary_op, types
    >>> @unary_op(types.FP64)
    ... def plus42(x):
    ...     return x + 42
    >>> A = Matrix.from_lists([0, 1], [1, 0], [1.0, 2.0])
    >>> print(A.apply(plus42))
          0  1
      0|   43.0|  0
      1|44.0   |  1
          0  1
    """

    def inner(func):
        return UnaryOp(func.__name__, arg_type.__name__, fn=func,
                       attach=False)

    return inner
