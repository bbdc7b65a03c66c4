"""Binary operators.

BinaryOp objects pair a name with a torch closure and a result-type
rule.  Built-ins are generated from the semantic table in
``ops/table.py`` (the JAX package's ``binaryop.py``); user ops are made
with the :func:`binary_op` decorator from a plain Python function over
tensors.  ``op(A, B)`` is the element-wise multiply ``A.emult(B, op)``.
"""

__all__ = ["BinaryOp", "Accum", "current_binop", "current_accum",
           "binary_op"]

import contextvars
import sys

import numpy as np

from . import _unsigned, types
from .ops import table

current_accum = contextvars.ContextVar("current_accum")
current_binop = contextvars.ContextVar("current_binop")


class BinaryOp:
    """A GraphBLAS binary operator z = f(x, y).

    Also a context manager: ``with op:`` sets the default operator."""

    def __init__(self, op, typ, fn=None, ztype="T", positional=None,
                 boolean=False, udt=None, attach=True, builtin=False):
        self.op = op
        self.type_name = typ
        self.fn = fn
        self.builtin = builtin
        self.ztype_rule = "BOOL" if boolean else ztype
        self.positional = positional
        self.udt = udt
        self.name = "_".join((op, typ))
        self.__doc__ = self.name
        self.token = None
        if attach and udt is None:
            cls = getattr(types, typ, None)
            if cls is not None:
                setattr(cls, op, self)
                setattr(cls, op.lower(), self)

    @property
    def type_cls(self):
        """The Type class the operator is defined on (None for a UDT op
        or a user op on an unknown type name)."""
        return self.udt or getattr(types, self.type_name, None)

    def __repr__(self):
        return f"<BinaryOp {self.name}>"

    def __enter__(self):
        self.token = current_binop.set(self)
        return self

    def __exit__(self, *errors):
        current_binop.reset(self.token)
        return False

    def __call__(self, A, B, *args, **kwargs):
        return A.emult(B, self, *args, **kwargs)

    def get_op(self):
        return self

    def ztype(self, input_type):
        """Result Type given the operand Type."""
        if self.ztype_rule == "BOOL":
            return types.BOOL
        if self.ztype_rule == "CMPLX":
            return types.FC32 if input_type == types.FP32 else types.FC64
        if self.positional is not None:
            return getattr(types, self.type_name)
        return input_type

    def apply(self, x, y, pos=None):
        """The operator on tensors of its type's held dtype (a struct
        UDT's op on dicts of member tensors; a structured numpy array is
        turned into one at this boundary).  A user op at UINT16, UINT32
        or UINT64 gets the unsigned values, as the JAX package's does
        (``_unsigned.call``)."""
        if self.positional is not None:
            key, off = self.positional
            return pos[key] + off
        if self.udt is not None and getattr(self.udt, "member_def", None):
            import numpy as np

            def as_dict(a):
                if isinstance(a, dict):
                    return a
                a = np.asarray(a)
                if a.dtype.names:
                    return self.udt.to_dict(a)
                return a

            zd = self.fn(as_dict(x), as_dict(y))
            if isinstance(zd, dict) and not isinstance(x, dict):
                return self.udt.from_dict(zd)
            return zd
        if self.builtin:
            return self.fn(x, y, self.type_cls)
        return _unsigned.call(self.fn, self.type_cls, x, y)


def at_type(op, typ):
    """The built-in op of `op`'s name at Type `typ` (the JAX closures take
    the dtype of the values they are given; the port's name their type):
    `op` itself for a user, UDT or positional op, or a name `typ` lacks."""
    if (op is None or not getattr(op, "builtin", False)
            or op.positional is not None or typ is None):
        return op
    return getattr(sys.modules[__name__], f"{op.op}_{typ.__name__}", op)


def np_binop(op):
    """numpy-vectorized closure of a BinaryOp: numpy arrays in and out,
    the op applied at the type of the first operand's dtype (a struct
    UDT op takes the structured arrays as they are)."""
    def fn(x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        if getattr(op, "udt", None) is not None:
            return np.asarray(op.apply(x, y))
        tx = types._gb_from_dtype(x.dtype)
        ty = types._gb_from_dtype(y.dtype)
        f = at_type(op, tx)
        z = f.apply(tx.to_torch(x), ty.to_torch(y.astype(x.dtype)))
        return f.ztype(tx).to_numpy(z)
    return fn


class Accum:
    """Context manager to set the default accumulator."""

    __slots__ = ("binaryop", "token")

    def __init__(self, binaryop):
        self.binaryop = binaryop

    def __enter__(self):
        self.token = current_accum.set(self.binaryop)
        return self

    def __exit__(self, *errors):
        current_accum.reset(self.token)
        return False


def build_binaryops(__pdoc__=None):
    """Instantiate every built-in BinaryOp and attach it to its type
    class and this module (``binaryop.PLUS_INT64`` and ``INT64.PLUS``)."""
    this = sys.modules[__name__]
    for op_name, spec in table.BINARY.items():
        for typ in spec["types"]:
            r = BinaryOp(op_name, typ, fn=spec["fn"], ztype=spec["ztype"],
                         positional=spec["positional"], builtin=True)
            setattr(this, r.name, r)
            if r.name not in __all__:
                __all__.append(r.name)
            if __pdoc__ is not None:
                __pdoc__[f"{typ}.{op_name}"] = f"BinaryOp {typ}.{op_name}"


def binary_op(arg_type, nopython=True, boolean=False):
    """Decorator turning a Python function over tensors into a
    BinaryOp.

    >>> from pygraphblas_tpu_torch import Matrix, binary_op, types
    >>> @binary_op(types.FP64)
    ... def plus3(x, y):
    ...     return x + y + 3
    >>> A = Matrix.from_lists([0, 1], [1, 0], [1.0, 2.0])
    >>> print(A.emult(A, plus3))
          0  1
      0|   5.0|  0
      1|7.0   |  1
          0  1
    """

    def inner(func):
        return BinaryOp(func.__name__, arg_type.__name__, fn=func,
                        boolean=boolean, attach=False)

    return inner
