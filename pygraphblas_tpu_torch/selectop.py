"""Select operators: predicates over (i, j, value, thunk).

The 16 built-in select ops of the JAX package's ``selectop.py`` and the
:func:`select_op` decorator for user predicates (a plain Python
function ``(i, j, x, thunk) -> bool`` over tensors), which
``Matrix.select`` and ``Vector.select`` apply at the container's type
(:meth:`SelectOp.at_type`): UINT16, UINT32 and UINT64 are held as
signed bit views, and a predicate reads them as their unsigned values.
At UINT64, which torch cannot widen, a user predicate is handed
:class:`Unsigned64` values (``_unsigned.Wrapping64``): they compare and
compute as uint64 on the int64 bits.

>>> from pygraphblas_tpu_torch import Matrix, selectop
>>> A = Matrix.from_lists([0, 0, 1], [0, 1, 1], [-1, 0, 1])
>>> print(A.select(selectop.LT_THUNK, 0))
      0  1
  0| -1   |  0
  1|      |  1
      0  1
"""

__all__ = ["SelectOp", "Unsigned64", "select_op"]

import operator
import sys

import torch

from . import _unsigned


class SelectOp:
    """A select predicate keep = f(i, j, x, thunk).  ``order`` is set on
    the built-in value comparisons: (comparison, against the thunk)."""

    __slots__ = ("name", "fn", "needs_thunk", "order")

    def __init__(self, name, fn, needs_thunk=False, order=None):
        self.name = name
        self.fn = fn
        self.needs_thunk = needs_thunk
        self.order = order

    def __repr__(self):
        return f"<SelectOp {self.name}>"

    def get_op(self):
        return self

    def apply(self, i, j, x, thunk):
        return self.fn(i, j, x, thunk)

    def at_type(self, T):
        """This predicate over values of type T, as the JAX package
        applies it.  At a bit view (UINT16/32/64) a built-in order
        comparison compares sign-flipped keys (``ops/table.py:_key``), so
        that signed order is the unsigned one; a user predicate is handed
        UINT16 and UINT32 values (and the thunk) widened to int32 and
        int64, the unsigned values the JAX package hands it, and UINT64
        ones as :class:`Unsigned64` (torch has no uint64 comparisons).
        Any other type, and the positional and equality built-ins, are
        unchanged."""
        if not getattr(T, "_view", False):
            return self
        if self.order is not None:
            cmp, on_thunk = self.order
            flip = -(1 << (T._bits - 1))

            def fn(i, j, x, t):
                ref = t.to(x.dtype) if on_thunk else torch.zeros_like(x)
                return cmp(x ^ flip, ref ^ flip)
        elif self is getattr(sys.modules[__name__], self.name, None):
            return self        # positional, ==, != (right on the view)
        elif T._bits == 64:
            def fn(i, j, x, t):
                r = self.fn(i, j, Unsigned64(x), Unsigned64(t))
                return r.bits if isinstance(r, Unsigned64) else r
        else:
            wide = torch.int32 if T._bits == 16 else torch.int64
            low = (1 << T._bits) - 1

            def fn(i, j, x, t):
                return self.fn(i, j, x.to(wide) & low, t.to(wide) & low)
        return SelectOp(self.name, fn, self.needs_thunk)


# a user predicate's UINT64 values: unsigned comparisons and arithmetic
# on the int64 bits (``_unsigned.Wrapping64``)
Unsigned64 = _unsigned.Wrapping64


_BUILTINS = {
    "TRIL": (lambda i, j, x, t: (j - i) <= t, True, 0),
    "TRIU": (lambda i, j, x, t: (j - i) >= t, True, 0),
    "DIAG": (lambda i, j, x, t: (j - i) == t, True, 0),
    "OFFDIAG": (lambda i, j, x, t: (j - i) != t, True, 0),
    "NONZERO": (lambda i, j, x, t: x != 0, False, None),
    "EQ_ZERO": (lambda i, j, x, t: x == 0, False, None),
    "GT_ZERO": (lambda i, j, x, t: x > 0, False, None),
    "GE_ZERO": (lambda i, j, x, t: x >= 0, False, None),
    "LT_ZERO": (lambda i, j, x, t: x < 0, False, None),
    "LE_ZERO": (lambda i, j, x, t: x <= 0, False, None),
    "NE_THUNK": (lambda i, j, x, t: x != t, True, None),
    "EQ_THUNK": (lambda i, j, x, t: x == t, True, None),
    "GT_THUNK": (lambda i, j, x, t: x > t, True, None),
    "GE_THUNK": (lambda i, j, x, t: x >= t, True, None),
    "LT_THUNK": (lambda i, j, x, t: x < t, True, None),
    "LE_THUNK": (lambda i, j, x, t: x <= t, True, None),
}

# default thunk when none is supplied (positional ops default to 0)
DEFAULT_THUNKS = {n: d for n, (_, _, d) in _BUILTINS.items()}

# the built-in order comparisons: (comparison, against the thunk)
_ORDER = {"GT_ZERO": (operator.gt, False), "GE_ZERO": (operator.ge, False),
          "LT_ZERO": (operator.lt, False), "LE_ZERO": (operator.le, False),
          "GT_THUNK": (operator.gt, True), "GE_THUNK": (operator.ge, True),
          "LT_THUNK": (operator.lt, True), "LE_THUNK": (operator.le, True)}


def build_selectops(__pdoc__=None):
    this = sys.modules[__name__]
    for name, (fn, needs_thunk, _default) in _BUILTINS.items():
        setattr(this, name, SelectOp(name, fn, needs_thunk,
                                     _ORDER.get(name)))
        if name not in __all__:
            __all__.append(name)
        if __pdoc__ is not None:
            __pdoc__[f"selectop.{name}"] = f"SelectOp {name}"


def select_op(arg_type, thunk_type=None):
    """Decorator turning a Python predicate ``(i, j, x, thunk) -> bool``
    into a SelectOp.

    >>> from pygraphblas_tpu_torch import Matrix, select_op, types
    >>> @select_op(types.FP64)
    ... def rowcol_sum_gt(i, j, x, v):
    ...     return (i + j) > v
    >>> A = Matrix.dense(types.FP64, 3, 3, fill=1)
    >>> A.select(rowcol_sum_gt, 2).nvals
    3
    """

    def inner(func):
        return SelectOp(func.__name__, func, needs_thunk=True)

    return inner
