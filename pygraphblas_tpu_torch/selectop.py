"""Select operators: predicates over (i, j, value, thunk).

The 16 built-in select ops of the JAX package's ``selectop.py`` and the
:func:`select_op` decorator for user predicates (a plain Python
function ``(i, j, x, thunk) -> bool`` over tensors), which
``Matrix.select`` and ``Vector.select`` apply.
"""

__all__ = ["SelectOp", "select_op"]

import sys


class SelectOp:
    """A select predicate keep = f(i, j, x, thunk)."""

    __slots__ = ("name", "fn", "needs_thunk")

    def __init__(self, name, fn, needs_thunk=False):
        self.name = name
        self.fn = fn
        self.needs_thunk = needs_thunk

    def __repr__(self):
        return f"<SelectOp {self.name}>"

    def get_op(self):
        return self

    def apply(self, i, j, x, thunk):
        return self.fn(i, j, x, thunk)


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


def build_selectops(__pdoc__=None):
    this = sys.modules[__name__]
    for name, (fn, needs_thunk, _default) in _BUILTINS.items():
        setattr(this, name, SelectOp(name, fn, needs_thunk))
        if name not in __all__:
            __all__.append(name)
        if __pdoc__ is not None:
            __pdoc__[f"selectop.{name}"] = f"SelectOp {name}"


def select_op(arg_type, thunk_type=None):
    """Decorator turning a Python predicate ``(i, j, x, thunk) -> bool``
    into a SelectOp."""

    def inner(func):
        return SelectOp(func.__name__, func, needs_thunk=True)

    return inner
