"""User operators at the unsigned bit-view types.

UINT16, UINT32 and UINT64 are held as signed bit views (int16, int32,
int64: ``types.py``), while the JAX package hands a user operator the
unsigned values.  ``call`` applies a user op's function as the JAX
package does: UINT16 values widened to int32 and UINT32 ones to int64
(their unsigned values), the result narrowed back to the held bit view
(a BOOL result stays BOOL).  Torch cannot widen UINT64, so a UINT64
function is handed :class:`Wrapping64` values: their comparisons are
the unsigned ones, the operations that give the same bits in the int64
view (``+``, ``-``, ``*``, negation, ``&``, ``|``, ``^``, ``~``,
``<<``, ``torch.where``, ``torch.minimum``/``maximum`` by unsigned
order) wrap as uint64 does, and anything else raises TypeError: never
the signed answer.
"""

import torch

_FLIP64 = -(1 << 63)


def call(fn, T, *args):
    """fn(*args) for a user op at Type T (held tensors in and out)."""
    if not getattr(T, "_view", False):
        return fn(*args)
    if T._bits == 64:
        z = fn(*(Wrapping64(a) for a in args))
        return z.bits if isinstance(z, Wrapping64) else z
    wide = torch.int32 if T._bits == 16 else torch.int64
    low = (1 << T._bits) - 1
    z = fn(*(a.to(wide) & low for a in args))
    if not isinstance(z, torch.Tensor) or z.dtype == torch.bool:
        return z
    if z.is_floating_point():
        z = z.to(torch.int64)
    return z.to(T.torch_dtype)


def _refuse(what):
    raise TypeError(
        f"a user operator at UINT64 can add, subtract, multiply, negate, "
        f"combine bitwise, shift left, compare (unsigned), torch.where "
        f"and torch.minimum/maximum its values, which torch holds as "
        f"int64 bits; not {what}: torch has no uint64 arithmetic")


def _bits(x):
    """A Wrapping64's bits, or a Python int's as int64 bits."""
    if isinstance(x, Wrapping64):
        return x.bits
    if isinstance(x, int) and not isinstance(x, bool) \
            and -(1 << 63) <= x < (1 << 64):
        return x - (1 << 64) if x >= (1 << 63) else x
    _refuse(type(x).__name__)


def _wrap(f):
    def op(self, other):
        return Wrapping64(f(self.bits, _bits(other)))
    return op


def _rwrap(f):
    def op(self, other):
        return Wrapping64(f(_bits(other), self.bits))
    return op


def _order(f):
    def op(self, other):
        return f(self.bits ^ _FLIP64, _bits(other) ^ _FLIP64)
    return op


def _tensor(x, like):
    b = _bits(x)
    return b if isinstance(b, torch.Tensor) else torch.full_like(like, b)


class Wrapping64:
    """UINT64 values held as their int64 bits, as a user operator sees
    them (see the module's note)."""

    __slots__ = ("bits",)
    __hash__ = None

    def __init__(self, bits):
        self.bits = bits

    __add__ = _wrap(lambda a, b: a + b)
    __radd__ = _rwrap(lambda a, b: a + b)
    __sub__ = _wrap(lambda a, b: a - b)
    __rsub__ = _rwrap(lambda a, b: a - b)
    __mul__ = _wrap(lambda a, b: a * b)
    __rmul__ = _rwrap(lambda a, b: a * b)
    __and__ = _wrap(lambda a, b: a & b)
    __rand__ = _rwrap(lambda a, b: a & b)
    __or__ = _wrap(lambda a, b: a | b)
    __ror__ = _rwrap(lambda a, b: a | b)
    __xor__ = _wrap(lambda a, b: a ^ b)
    __rxor__ = _rwrap(lambda a, b: a ^ b)
    __lt__ = _order(lambda a, b: a < b)
    __le__ = _order(lambda a, b: a <= b)
    __gt__ = _order(lambda a, b: a > b)
    __ge__ = _order(lambda a, b: a >= b)

    def __eq__(self, other):
        return self.bits == _bits(other)

    def __ne__(self, other):
        return self.bits != _bits(other)

    def __lshift__(self, k):
        if not isinstance(k, int) or not 0 <= k < 64:
            _refuse(f"a shift by {k!r}")
        return Wrapping64(self.bits << k)

    def __neg__(self):
        return Wrapping64(-self.bits)

    def __invert__(self):
        return Wrapping64(~self.bits)

    def __pos__(self):
        return self

    def __bool__(self):
        _refuse("truth testing")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if kwargs:
            _refuse(f"{getattr(func, '__name__', func)} with keywords")
        if func is torch.where and len(args) == 3:
            cond, a, b = args
            like = a.bits if isinstance(a, Wrapping64) else b.bits
            return Wrapping64(torch.where(cond, _tensor(a, like),
                                          _tensor(b, like)))
        if func in (torch.minimum, torch.maximum) and len(args) == 2:
            a, b = (x if isinstance(x, Wrapping64) else Wrapping64(_tensor(
                x, args[0].bits if isinstance(args[0], Wrapping64)
                else args[1].bits)) for x in args)
            lt = a < b
            pick = lt if func is torch.minimum else ~lt
            return Wrapping64(torch.where(pick, a.bits, b.bits))
        _refuse(getattr(func, "__name__", str(func)))

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        _refuse(f"attribute {name!r}")


def _refuse_op(name):
    def op(self, *args):
        _refuse(name)
    op.__name__ = name
    return op


for _name in ("truediv", "rtruediv", "floordiv", "rfloordiv", "mod", "rmod",
              "pow", "rpow", "rlshift", "rshift", "rrshift", "abs", "int",
              "float", "index", "getitem", "divmod", "rdivmod"):
    setattr(Wrapping64, f"__{_name}__", _refuse_op(f"__{_name}__"))
del _name
